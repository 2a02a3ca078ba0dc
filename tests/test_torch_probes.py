"""PyTorch port, the gather probes (graphblas_tpu_torch/tools): their
kernels' plain versions on the CPU against the JAX probes and numpy, the
wrappers' checks, and the kernels against the plain versions on the card.

The JAX side runs on the CPU: the row gather against the JAX probe's
Pallas kernel body (``tools/gather_probe.py``) in interpret mode, the
gather-dot against ``xla_ref`` of ``tools/gatherdot_probe.py``.  That
module runs its TPU workload when imported, so ``xla_ref`` is compiled
from its own source.  Gathers must be exactly equal, gather-dots within
S * 2^-24 * sum |a * b| of a float64 sum."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from graphblas_tpu_torch.sparse import valdot as tvd
from graphblas_tpu_torch.tools import gather_probe as gp
from graphblas_tpu_torch.tools import gatherdot_probe as gdp


def _gather_case(rows, width, per_row, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((rows, width), np.float32)
    idx = rng.integers(0, width, (rows, per_row), dtype=np.int32)
    return x, idx


# the TPU probe's 128-lane shape (fewer rows), and the two forms Mosaic
# refused: a 512-wide window with 128 indices, and a 64-row axis-0 gather
# (as its transpose)
@pytest.mark.parametrize("rows,width,per_row", [(512, 128, 128),
                                                (256, 512, 128),
                                                (128, 64, 64),
                                                (3, 1536, 7)])
def test_row_gather_plain_matches_numpy(rows, width, per_row):
    x, idx = _gather_case(rows, width, per_row, rows + width)
    got = gp.row_gather(torch.from_numpy(x), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), np.take_along_axis(x, idx, 1))


def test_row_gather_axis0_form():
    rng = np.random.default_rng(3)
    x = rng.random((64, 128), np.float32)
    idx = rng.integers(0, 64, (64, 128), dtype=np.int32)
    got = gp.row_gather(torch.from_numpy(x.T.copy()),
                        torch.from_numpy(idx.T.copy())).t()
    assert np.array_equal(got.numpy(), np.take_along_axis(x, idx, 0))


def _jax_lane_shuffle(x, idx, block_rows):
    """The JAX probe's 128-lane shuffle kernel (``probe_lane_shuffle``),
    its body and block specs, run in interpret mode."""
    R, W = idx.shape

    def kern(x_ref, idx_ref, o_ref):
        o_ref[...] = jnp.take_along_axis(x_ref[...], idx_ref[...], axis=1)

    f = pl.pallas_call(
        kern, grid=(R // block_rows,),
        in_specs=[pl.BlockSpec((block_rows, x.shape[1]), lambda i: (i, 0)),
                  pl.BlockSpec((block_rows, W), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block_rows, W), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((R, W), jnp.float32), interpret=True)
    return np.asarray(f(jnp.asarray(x), jnp.asarray(idx)))


# the probe's 128-lane form (fewer rows, its 512-row blocks) and its
# 512-wide window with 128 indices per row
@pytest.mark.parametrize("rows,width,block_rows", [(1024, 128, 512),
                                                   (256, 512, 128)])
def test_row_gather_matches_jax_probe_kernel(rows, width, block_rows):
    x, idx = _gather_case(rows, width, 128, rows * 7 + width)
    got = gp.row_gather(torch.from_numpy(x), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), _jax_lane_shuffle(x, idx, block_rows))


def test_row_gather_axis0_matches_jax():
    """The probe's 64-row axis-0 form, ``take_along_axis(axis=0)``."""
    rng = np.random.default_rng(5)
    x = rng.random((64, 128), np.float32)
    idx = rng.integers(0, 64, (64, 128), dtype=np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx),
                                          axis=0))
    got = gp.row_gather(torch.from_numpy(x.T.copy()),
                        torch.from_numpy(idx.T.copy())).t()
    assert np.array_equal(got.numpy(), want)


def _jax_xla_ref(E):
    """``xla_ref`` of the JAX gather-dot probe, compiled from its source
    (importing the module runs the TPU workload) with the probe's entry
    count set to ``E``."""
    path = pathlib.Path(__file__).parents[1] / "tools" / "gatherdot_probe.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "xla_ref")
    scope = {"jax": jax, "jnp": jnp, "E": E}
    exec(compile(ast.Module([fn], []), str(path), "exec"), scope)
    return scope["xla_ref"]


def test_gatherdot_matches_jax_probe_xla_ref():
    """The port's gather-dot (plain version on the CPU) and K4 against
    the JAX probe's ``xla_ref`` on the same tables, at the probe's row
    width S = 1024 fed as its (NA, 8, S/8) layout, fewer rows and
    entries (E a multiple of the probe's 64 map steps)."""
    na, S, E = 200, gdp.S, 64 * 40
    rng = np.random.default_rng(11)
    A = rng.random((na, S), np.float32)
    B = rng.random((na, S), np.float32)
    ai = rng.integers(0, na, E).astype(np.int32)
    bj = rng.integers(0, na, E).astype(np.int32)
    want = np.asarray(_jax_xla_ref(E)(
        jnp.asarray(ai), jnp.asarray(bj),
        Aval=jnp.asarray(A.reshape(na, 8, S // 8)),
        Bval=jnp.asarray(B.reshape(na, 8, S // 8)))).astype(np.float64)
    terms = A[ai].astype(np.float64) * B[bj]
    tol = 2 * S * 2.0 ** -24 * np.abs(terms).sum(1)
    assert (np.abs(want - terms.sum(1)) <= tol / 2).all()
    args = [torch.from_numpy(a) for a in (A, B, ai, bj)]
    for got in (gdp.gatherdot_async(*args), tvd.valdot_gatherdot(*args, E)):
        assert (np.abs(got.numpy().astype(np.float64) - want) <= tol).all()


def test_row_gather_checks_its_arguments():
    x = torch.zeros((4, 8))
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        gp.row_gather(x.double(), idx)
    with pytest.raises(TypeError):
        gp.row_gather(x, idx.long())
    with pytest.raises(ValueError):
        gp.row_gather(torch.zeros((4, gp.MAX_WINDOW + 1)), idx)
    with pytest.raises(ValueError):
        gp.row_gather(x, idx[:3])
    # out-of-range indices clamp into the window, as the kernel's do
    got = gp.row_gather(torch.arange(8.0).reshape(1, 8),
                        torch.tensor([[-3, 9]], dtype=torch.int32))
    assert got.tolist() == [[0.0, 7.0]]


@pytest.mark.parametrize("na,S,E", [(300, 1024, 2000), (50, 12, 333)])
def test_gatherdot_async_plain_matches_numpy_and_k4(na, S, E):
    rng = np.random.default_rng(na + S)
    A = rng.random((na, S), np.float32) - 0.5
    B = rng.random((na + 7, S), np.float32) - 0.5
    ai = rng.integers(0, na, E).astype(np.int32)
    bj = rng.integers(0, na + 7, E).astype(np.int32)
    args = [torch.from_numpy(a) for a in (A, B, ai, bj)]
    got = gdp.gatherdot_async(*args).numpy().astype(np.float64)
    terms = A[ai].astype(np.float64) * B[bj]
    tol = S * 2.0 ** -24 * np.abs(terms).sum(1)
    assert (np.abs(got - terms.sum(1)) <= tol).all()
    k4 = tvd.valdot_gatherdot(*args, E).numpy()
    assert (np.abs(k4 - terms.sum(1)) <= tol).all()


def _pairs_case(case):
    """Tables and pairs for the grouped kernel: ``long_runs`` (three A
    rows), ``runs_of_one`` (distinct A rows), ``below_ring`` (E under
    the ring's depth) and ``above_ring`` (random, with out-of-range rows
    the kernel clamps)."""
    rng = np.random.default_rng(len(case))
    na, S = 150, 64
    E = {"long_runs": 300, "runs_of_one": 100, "below_ring": 5,
         "above_ring": 1000}[case]
    A = rng.random((na, S), np.float32) - 0.5
    B = rng.random((na + 5, S), np.float32) - 0.5
    if case == "long_runs":
        ai = rng.choice([4, 77, 149], E)
    elif case == "runs_of_one":
        ai = rng.permutation(na)[:E]
    else:
        ai = rng.integers(0, na, E)
    bj = rng.integers(0, na + 5, E)
    if case == "above_ring":
        ai[:3], bj[:3] = (-1, na, na + 9), (na + 5, -4, 0)
    return [torch.from_numpy(x) for x in (A, B, ai.astype(np.int32),
                                          bj.astype(np.int32))]


def _kernel_walk(A, B, ai, bj, blocks, stages=gdp.RING_STAGES):
    """The wrapper's run plan and the kernel's walk, in Python: the
    pairs sorted by ai (group_pairs), cut into the blocks' chunks; in a
    chunk a run of equal (clamped) ai takes A slot run % stages, entry i
    B stage i % stages, and the producer runs as far ahead as the ring
    lets it (entry i + stages - 1 before entry i is released); the
    result goes to out[perm[i]].  Returns (out, A rows loaded)."""
    ai_s, bj_s, perm = gdp.group_pairs(ai, bj)
    a_c = ai_s.long().clamp(0, A.shape[0] - 1).tolist()
    b_c = bj_s.long().clamp(0, B.shape[0] - 1).tolist()
    perm = perm.tolist()
    E = len(a_c)
    out = torch.full((E,), float("nan"))
    chunk = -(-E // blocks)
    loads = 0
    for p0 in range(0, E, chunk):
        n = min(chunk, E - p0)
        aslot, bstage, meta = [None] * stages, [None] * stages, [None] * stages
        run, filled = -1, 0
        for i in range(n):
            while filled < min(n, i + stages):     # the producer
                f = filled
                if f == 0 or a_c[p0 + f] != a_c[p0 + f - 1]:
                    run += 1
                    aslot[run % stages] = (run, a_c[p0 + f])
                    loads += 1
                bstage[f % stages] = b_c[p0 + f]
                meta[f % stages] = (run, perm[p0 + f])
                filled += 1
            r, o = meta[i % stages]                # a consumer
            slot_run, arow = aslot[r % stages]
            assert slot_run == r and arow == a_c[p0 + i]
            out[o] = (A[arow] * B[bstage[i % stages]]).sum()
    return out, loads


@pytest.mark.parametrize("case", ["long_runs", "runs_of_one", "below_ring",
                                  "above_ring"])
def test_gatherdot_run_plan(case):
    """P2's run plan (sort by ai, runs, A slots and B stages of the
    ring, the scatter back to pair order) gives the plain version's
    result, each A row loaded once a run of its chunk."""
    A, B, ai, bj = _pairs_case(case)
    want = gdp._gatherdot_async_plain(A.double(), B.double(), ai, bj)
    tol = A.shape[1] * 2.0 ** -24 * gdp._gatherdot_async_plain(
        A.double().abs(), B.double().abs(), ai, bj)
    runs = int(torch.unique(ai.clamp(0, A.shape[0] - 1)).numel())
    for blocks in (1, 3, 7):
        got, loads = _kernel_walk(A, B, ai, bj, blocks)
        assert not bool(torch.isnan(got).any())
        assert bool(((got.double() - want).abs() <= tol).all())
        assert runs <= loads <= runs + blocks - 1
    assert torch.equal(gdp.gatherdot_async(A, B, ai, bj),
                       gdp._gatherdot_async_plain(A, B, ai, bj))


def test_gatherdot_async_checks_its_arguments():
    A = torch.zeros((4, 8))
    i = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        gdp.gatherdot_async(A.double(), A, i, i)
    with pytest.raises(ValueError):
        gdp.gatherdot_async(torch.zeros((4, 6)), torch.zeros((4, 6)), i, i)
    with pytest.raises(ValueError):
        gdp.gatherdot_async(torch.zeros((4, 4096)), torch.zeros((4, 4096)),
                            i, i)
    with pytest.raises(ValueError):
        gdp.gatherdot_async(A, A, i, i[:2])


def test_tables_are_the_tpu_probes():
    A, B, ai, bj = gdp.make_tables("cpu")
    assert A.shape == B.shape == (gdp.NA, gdp.S) == (32768, 1024)
    assert ai.shape == bj.shape == (gdp.E,) == (65536,)
    assert ai.dtype == torch.int32 and int(ai.max()) < gdp.NA


def test_probes_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        gp.run()
    with pytest.raises(SystemExit):
        gdp.run()


@pytest.mark.cuda
def test_probe_kernels_on_card():
    """Both kernels against their plain versions on the card; the
    grouped gather-dot also on long runs, runs of one, fewer entries than
    its ring's stages and clamped rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, idx = _gather_case(4096, 512, 128, 1)
    xt, it = torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()
    assert torch.equal(gp.row_gather(xt, it), gp._row_gather_plain(xt, it))
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.random((5000, 1024), np.float32)).cuda()
    ai = torch.from_numpy(rng.integers(0, 5000, 20000).astype(np.int32))
    bj = torch.from_numpy(rng.integers(0, 5000, 20000).astype(np.int32))
    ai, bj = ai.cuda(), bj.cuda()
    ref = gdp._gatherdot_async_plain(A.double(), A.double(), ai, bj)
    got = gdp.gatherdot_async(A, A, ai, bj).double()
    assert bool(((got - ref).abs() <= 1024 * 2.0 ** -24 * ref).all())
    # the grouped kernel on the run plan's cases, with its grouping pass
    # and on pairs handed over grouped (results in their order)
    from graphblas_tpu_torch import _build
    for case in ("long_runs", "runs_of_one", "below_ring", "above_ring"):
        A, B, ai, bj = (x.cuda() for x in _pairs_case(case))
        want = gdp._gatherdot_async_plain(A.double(), B.double(), ai, bj)
        tol = A.shape[1] * 2.0 ** -24 * gdp._gatherdot_async_plain(
            A.double().abs(), B.double().abs(), ai, bj)
        ai_g, bj_g, perm = gdp.group_pairs(ai, bj)
        before = _build.launches["gatherdot_async"]
        got = gdp.gatherdot_async(A, B, ai, bj).double()
        pre = gdp.gatherdot_async(A, B, ai_g, bj_g, grouped=True).double()
        torch.cuda.synchronize()
        assert _build.launches["gatherdot_async"] == before + 2
        assert bool(((got - want).abs() <= tol).all()), case
        assert bool(((pre - want[perm.long()]).abs()
                     <= tol[perm.long()]).all()), case
