"""PyTorch port, the complex types FC32 and FC64: parity with the JAX
package.

Every unary and binary family runs on both types over a grid of values
with zeros, NaN, infinities, huge and tiny parts, against the JAX
package on the CPU.  Exact where the arithmetic is exact (PLUS, MINUS,
the comparisons and their IS* forms, the logical ops, FIRST/SECOND/
PAIR/ANY, IDENTITY, AINV, LNOT, ONE, the casts in both directions, and
MIN/MAX where no NaN meets them); TIMES, DIV, RDIV, MINV and ABS within
rtol 1e-12 (FC64) or 1e-5 (FC32) on finite operands with finite results
(the JAX CPU backend fuses multiply-adds and recovers C99-style on
infinite operands).  Then the monoid reduces, the bitmap, ESC and
valdot ``mxm`` (the JAX package's ``test_my_complex_semiring`` with a
port-side semiring), ``mxv``, the element-wise ops and ``from_jax``.

Complex MIN and MAX drop a NaN operand in the port (the rule its float
MIN/MAX folds follow); the JAX package picks ``x if x <lex y else y``,
so ``min(0, nan+0j)`` is the NaN there and its folds depend on the
order.  ``test_nan_min_max_pinned`` records both packages' values
(ROADMAP.md queue 3, "known in the reference").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.core import monoids as jmonoids
from graphblas_tpu.core import ops as jops
from graphblas_tpu.core import types as jtypes
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.convert import from_jax
from graphblas_tpu_torch.core import ops as tops
from graphblas_tpu_torch.core import types as ttypes
from graphblas_tpu_torch.sparse import esc as tesc
from graphblas_tpu_torch.sparse import valdot as tvd

CPU = "cpu"
CTYPES = ["FC32", "FC64"]
RTOL = {"FC32": 1e-5, "FC64": 1e-12}
NPDT = {"FC32": np.complex64, "FC64": np.complex128}
_PARTS = [0.0, -0.0, 1.5, -2.5, np.inf, -np.inf, np.nan, 1e30, 1e-30, 3.0]
_GRID = np.array([complex(a, b) for a in _PARTS for b in _PARTS])
_X, _Y = (g.ravel() for g in np.meshgrid(_GRID, _GRID))

EXACT_BINARY = ["first", "second", "pair", "any", "plus", "minus", "rminus",
                "iseq", "isne", "isgt", "islt", "isge", "isle", "lor", "land",
                "lxor", "eq", "ne", "gt", "lt", "ge", "le"]
ROUNDED_BINARY = ["times", "div", "rdiv"]
EXACT_UNARY = ["identity", "ainv", "lnot", "one"]
ROUNDED_UNARY = ["minv", "abs"]


def _has_nan(z):
    return np.isnan(z.real) | np.isnan(z.imag)


def same_bits(got, want):
    """Equal part by part, NaN equal to NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if got.dtype.kind != "c":
        assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")
        return
    for part in ("real", "imag"):
        assert np.array_equal(getattr(got, part), getattr(want, part),
                              equal_nan=True), part


def _pair(tname):
    x, y = _X.astype(NPDT[tname]), _Y.astype(NPDT[tname])
    return x, y


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("name", EXACT_BINARY)
def test_binary_family_exact(tname, name):
    x, y = _pair(tname)
    want = jops.binary[name][getattr(jtypes, tname)](jnp.asarray(x),
                                                     jnp.asarray(y))
    got = tops.binary[name][getattr(ttypes, tname)](torch.from_numpy(x),
                                                    torch.from_numpy(y))
    same_bits(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("name", ["min", "max"])
def test_min_max_exact_without_nan(tname, name):
    """MIN/MAX are the JAX package's lexicographic pick wherever no NaN
    meets them (±inf and signed zeros included)."""
    x, y = _pair(tname)
    ok = ~(_has_nan(x) | _has_nan(y))
    x, y = x[ok], y[ok]
    want = jops.binary[name][getattr(jtypes, tname)](jnp.asarray(x),
                                                     jnp.asarray(y))
    got = tops.binary[name][getattr(ttypes, tname)](torch.from_numpy(x),
                                                    torch.from_numpy(y))
    same_bits(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("name", ["min", "max"])
def test_min_max_nan_drops_out(tname, name):
    """A NaN operand drops out: the other operand wins (the port's rule
    for float MIN/MAX); two NaN operands give the second."""
    x, y = _pair(tname)
    got = tops.binary[name][getattr(ttypes, tname)](
        torch.from_numpy(x), torch.from_numpy(y)).numpy()
    xn, yn = _has_nan(x), _has_nan(y)
    same_bits(got[xn], y[xn])
    same_bits(got[yn & ~xn], x[yn & ~xn])


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("name", ROUNDED_BINARY)
def test_binary_family_rounded(tname, name):
    x, y = _pair(tname)
    with np.errstate(all="ignore"):
        want = np.asarray(jops.binary[name][getattr(jtypes, tname)](
            jnp.asarray(x), jnp.asarray(y)))
    got = tops.binary[name][getattr(ttypes, tname)](
        torch.from_numpy(x), torch.from_numpy(y)).numpy()
    fin = (np.isfinite(x) & np.isfinite(y) & np.isfinite(want)
           & (np.abs(want) > 1e-20) & (np.abs(want) < 1e20))
    assert fin.sum() > 300
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL[tname])
    assert got.dtype == want.dtype


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("name", EXACT_UNARY + ROUNDED_UNARY)
def test_unary_family(tname, name):
    x = _GRID.astype(NPDT[tname])
    want = np.asarray(jops.unary[name][getattr(jtypes, tname)](
        jnp.asarray(x)))
    got = tops.unary[name][getattr(ttypes, tname)](
        torch.from_numpy(x)).numpy()
    if name in EXACT_UNARY:
        same_bits(got, want)
        return
    fin = np.isfinite(x) & np.isfinite(want) & (np.abs(want) > 1e-20)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL[tname])
    assert got.dtype == want.dtype


def test_minv_of_zero_and_abs_magnitude():
    for tname in CTYPES:
        t = getattr(ttypes, tname)
        z = tops.unary["minv"][t](torch.zeros(1, dtype=t.storage)).numpy()
        assert np.isinf(z.real[0]) and z.real[0] > 0 and np.isnan(z.imag[0])
        a = tops.unary["abs"][t](torch.tensor([3 + 4j], dtype=t.storage))
        assert a.dtype == t.storage and a.numpy()[0] == 5 + 0j


@pytest.mark.cuda
@pytest.mark.parametrize("tname", CTYPES)
def test_families_on_card_match_cpu(tname):
    """The card's complex families give the CPU's values on the grid:
    exact where the arithmetic is exact (PLUS/MINUS on the real view
    included), within rounding for TIMES, DIV, RDIV, MINV and ABS on
    finite results, and MINV(0) = inf+nanj."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = getattr(ttypes, tname)
    x, y = _pair(tname)
    xc, yc = torch.from_numpy(x), torch.from_numpy(y)
    for name in EXACT_BINARY + ["min", "max"] + ROUNDED_BINARY:
        op = tops.binary[name][t]
        want = op(xc, yc).numpy()
        got = op(xc.cuda(), yc.cuda()).cpu().numpy()
        if name in ROUNDED_BINARY:
            fin = (np.isfinite(want) & (np.abs(want) > 1e-20)
                   & (np.abs(want) < 1e20))
            np.testing.assert_allclose(got[fin], want[fin],
                                       rtol=RTOL[tname], err_msg=name)
        else:
            same_bits(got, want)
    g = torch.from_numpy(_GRID.astype(NPDT[tname]))
    for name in EXACT_UNARY + ROUNDED_UNARY:
        op = tops.unary[name][t]
        want, got = op(g).numpy(), op(g.cuda()).cpu().numpy()
        if name in EXACT_UNARY:
            same_bits(got, want)
        else:
            fin = np.isfinite(want) & (np.abs(want) > 1e-20)
            np.testing.assert_allclose(got[fin], want[fin],
                                       rtol=RTOL[tname], err_msg=name)
    z = tops.unary["minv"][t](torch.zeros(1, dtype=t.storage,
                                          device="cuda")).cpu().numpy()
    assert np.isinf(z.real[0]) and z.real[0] > 0 and np.isnan(z.imag[0])


_CAST_IN = np.array([1.7 - 2.5j, -3.9 + 1j, np.nan + 1j, 0, 1e20,
                     np.inf - 1j, -np.inf, 255.9 + 0j, -1e10 + 7j])


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("dst", [t.name for t in ttypes.BUILTIN_TYPES]
                         + CTYPES)
def test_cast_from_complex(tname, dst):
    x = _CAST_IN.astype(NPDT[tname])
    want = np.asarray(jtypes.cast(jnp.asarray(x), getattr(jtypes, dst)))
    t = getattr(ttypes, dst)
    got = ttypes.cast(torch.from_numpy(x), t, getattr(ttypes, tname))
    got = got.numpy()
    if t.is_unsigned:
        got = got.view(t.dtype)
    same_bits(got, want)


def test_cast_from_complex_anchors():
    """The values of ROADMAP.md's complex cast rules."""
    x = torch.tensor([1.7 - 2.5j, -3.9 + 1j, complex(np.nan, 1), 0, 1e20],
                     dtype=torch.complex64)
    assert ttypes.cast(x, ttypes.INT32, ttypes.FC32).tolist() == \
        [1, -3, 0, 0, 2147483647]
    assert ttypes.cast(x, ttypes.UINT8, ttypes.FC32).numpy().view(
        np.uint8).tolist() == [1, 0, 0, 0, 255]
    assert ttypes.cast(x, ttypes.BOOL, ttypes.FC32).tolist() == \
        [True, True, True, False, True]
    assert ttypes.cast_value(1.7 - 2.5j, ttypes.INT32) == 1
    assert ttypes.cast_value(complex(np.nan, 1), ttypes.UINT8) == 0


@pytest.mark.parametrize("src", [t.name for t in ttypes.BUILTIN_TYPES])
@pytest.mark.parametrize("tname", CTYPES)
def test_cast_to_complex(src, tname):
    s = getattr(ttypes, src)
    if s.is_bool:
        x = np.array([True, False, True])
    elif s.is_integer:
        info = np.iinfo(s.dtype)
        x = np.array([info.min, 0, 1, info.max, 7], s.dtype)
    else:
        x = np.array([1.5, np.nan, -np.inf, 0.0, 1e30], s.dtype)
    want = np.asarray(jtypes.cast(jnp.asarray(x), getattr(jtypes, tname)))
    got = ttypes.cast(torch.from_numpy(np.array(s.to_storage(x))),
                      getattr(ttypes, tname), s).numpy()
    same_bits(got, want)


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("mon", ["plus", "times", "min", "max", "lor",
                                 "land", "lxor"])
def test_monoid_reduce(tname, mon):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(7, 9)) + 1j * rng.normal(size=(7, 9))
         ).astype(NPDT[tname])
    x[2, 3] = 0
    jm = jmonoids.monoid[mon][getattr(jtypes, tname)]
    tm = gt.monoid[mon][getattr(ttypes, tname)]
    for axis in (None, 1):
        want = np.asarray(jm.reduce(jnp.asarray(x), axis=axis))
        got = tm.reduce(torch.from_numpy(x), axis=axis).numpy()
        if mon in ("lor", "land"):
            # the op's own fold (ROADMAP.md queue 3: the JAX package
            # takes a max/min of the values)
            nz = x != 0
            r = nz.any(axis=axis) if mon == "lor" else nz.all(axis=axis)
            same_bits(got, np.asarray(r).astype(NPDT[tname]))
        elif mon in ("min", "max", "lxor"):
            same_bits(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL[tname] * 10)
    assert tm.identity_value() == jm.identity
    if mon in ("min", "max"):
        ident = tm.identity_value()
        assert ident.imag == 0 and np.isinf(ident.real)


def test_nan_min_max_pinned():
    """The JAX package's complex MIN/MAX under NaN, and the port's."""
    fc = np.complex64
    zero, nan0, nan1 = fc(0), fc(complex(np.nan, 0)), fc(complex(np.nan, 1))
    jmax = jops.binary.max[jtypes.FC32]
    tmax = tops.binary.max[ttypes.FC32]
    # JAX: max(nan+1j, 0) = 0 but max(0, nan+0j) = nan+0j
    assert np.asarray(jmax(jnp.asarray(nan1), jnp.asarray(zero))) == 0
    assert np.isnan(np.asarray(jmax(jnp.asarray(zero), jnp.asarray(nan0))))
    # the port: the NaN operand drops out either way
    assert tmax(torch.tensor(nan1), torch.tensor(zero)).item() == 0
    assert tmax(torch.tensor(zero), torch.tensor(nan0)).item() == 0
    x = np.array([1.7 - 2.5j, -3.9 + 1j, complex(np.nan, 1), 0, 1e20], fc)
    want = np.asarray(jmonoids.monoid.min[jtypes.FC32].reduce(
        jnp.asarray(x)))
    assert want == 0j                      # the JAX fold meets the NaN
    got = gt.monoid.min[ttypes.FC32].reduce(torch.from_numpy(x)).item()
    assert got == -3.9 + 1j or abs(got - (-3.9 + 1j)) < 1e-6
    got = gt.monoid.max[ttypes.FC32].reduce(torch.from_numpy(x)).item()
    assert got == 1e20 + 0j or abs(got - 1e20) < 1e14
    # every engine folds by the same rule: the CSR row reduce too
    A = gt.CsrMatrix.from_coo(np.zeros(5, np.int64), np.arange(5), x, 1, 5,
                              type=gt.FC32, device=CPU)
    w = gt.reduce_to_vector(gt.Vector.new(gt.FC32, 1, device=CPU), None,
                            None, gt.monoid.min[gt.FC32], A)
    assert abs(w.to_dense()[0] - (-3.9 + 1j)) < 1e-6


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("mon", ["min", "max"])
def test_min_max_infinite_real_parts_every_engine(tname, mon):
    """Complex MIN/MAX fold from the identity (``±inf+0j``) on every
    engine: a row whose best real part is the identity's infinity takes
    the better imaginary part of its terms and the identity's 0, full
    bitmap row, bitmap row with absent entries and CSR row alike."""
    inf = np.inf if mon == "min" else -np.inf
    rows = np.array([[complex(inf, -5), complex(inf, 7), complex(inf, 2)],
                     [complex(inf, 3), complex(inf, -4), 1 + 1j],
                     [complex(-inf, 1), complex(inf, 9), complex(inf, -1)]],
                    NPDT[tname])
    pat = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]], bool)
    t = getattr(gt, tname)
    m = gt.monoid[mon][t]
    pick = min if mon == "min" else max
    want = []
    for r, p in zip(rows, pat):
        terms = [complex(v) for v in r[p]] + [complex(inf, 0)]
        best = pick(v.real for v in terms)
        want.append(complex(best, pick(v.imag for v in terms
                                        if v.real == best)))
    want = np.array(want, NPDT[tname])
    # the monoid's own fold over full rows (row 1 without its absent term)
    full = m.reduce(torch.from_numpy(rows), axis=1).numpy()
    same_bits(full[[0, 2]], want[[0, 2]])
    # bitmap with an absent entry, and the CSR row reduce
    A = gt.Matrix.from_dense(rows, t, pattern=pat, device=CPU)
    i, j = np.nonzero(pat)
    Ac = gt.CsrMatrix.from_coo(i, j, rows[pat], 3, 3, type=t, device=CPU)
    for src in (A, Ac):
        w = gt.reduce_to_vector(gt.Vector.new(t, 3, device=CPU), None, None,
                                m, src)
        same_bits(w.to_dense(), want)


def _cdense(rng, m, n, density, tname):
    pat = rng.random((m, n)) < density
    v = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) * pat
    return v.astype(NPDT[tname]), pat


@pytest.mark.parametrize("tname", CTYPES)
def test_my_complex_semiring(tname):
    """The JAX package's ``test_my_complex_semiring`` with a port-side
    semiring: the bitmap product is one complex matmul."""
    rng = np.random.default_rng(4)
    Ad = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    Bd = rng.normal(size=(4, 2)) + 1j * rng.normal(size=(4, 2))
    t = getattr(gt, tname)
    sr = gt.semiring_new(gt.monoid.plus[t], gt.binary.times[t])
    A = gt.Matrix.from_dense(Ad, t, device=CPU)
    B = gt.Matrix.from_dense(Bd, t, device=CPU)
    C = gt.mxm(gt.Matrix.new(t, 3, 2, device=CPU), None, None, sr, A, B)
    assert gt.last_axb_method() == "mxu:plus_times"
    assert np.allclose(C.to_dense(), Ad @ Bd, rtol=RTOL[tname] * 10)
    Cj = gb.mxm(gb.Matrix.new(getattr(gb, tname), 3, 2), None, None,
                gb.semiring.plus_times[getattr(gb, tname)],
                gb.Matrix.from_dense(Ad.astype(NPDT[tname]),
                                     getattr(gb, tname)),
                gb.Matrix.from_dense(Bd.astype(NPDT[tname]),
                                     getattr(gb, tname)))
    np.testing.assert_allclose(C.to_dense(), np.asarray(Cj.to_dense()),
                               rtol=RTOL[tname])


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("sem", ["plus_times", "plus_first", "min_plus",
                                 "max_times", "plus_minus"])
def test_mxm_engines_match_jax(tname, sem):
    """Bitmap and forced-ESC ``mxm`` (masked and unmasked) against the
    JAX bitmap product; the valdot plan refuses a complex semiring, so
    a masked CSR product runs ESC."""
    rng = np.random.default_rng(6)
    Ad, Ap = _cdense(rng, 12, 10, 0.4, tname)
    Bd, Bp = _cdense(rng, 10, 11, 0.4, tname)
    Md = rng.random((12, 11)) < 0.5
    jt, tt = getattr(gb, tname), getattr(gt, tname)
    jsr = gb.semiring[sem][jt]
    tsr = gt.semiring[sem][tt]
    # by type: an FC64 product computed in complex64 fails the FC64 case
    tol = (dict(rtol=1e-12, atol=1e-12) if tname == "FC64"
           else dict(rtol=RTOL[tname] * 10, atol=1e-5))
    for M in (None, Md):
        Mj = gb.Matrix.from_dense(M, gb.BOOL) if M is not None else None
        want = gb.mxm(gb.Matrix.new(jt, 12, 11), Mj, None, jsr,
                      gb.Matrix.from_dense(Ad, jt, pattern=Ap),
                      gb.Matrix.from_dense(Bd, jt, pattern=Bp))
        wv, wp = np.asarray(want.to_dense()), np.asarray(want.pattern)
        A = gt.Matrix.from_dense(Ad, tt, pattern=Ap, device=CPU)
        B = gt.Matrix.from_dense(Bd, tt, pattern=Bp, device=CPU)
        Mt = (gt.Matrix.from_dense(M, gt.BOOL, device=CPU)
              if M is not None else None)
        got = gt.mxm(gt.Matrix.new(tt, 12, 11, device=CPU), Mt, None, tsr,
                     A, B)
        assert np.array_equal(got.pattern_np(), wp)
        np.testing.assert_allclose(got.to_dense()[wp], wv[wp], **tol)
        Ac, Bc = gt.CsrMatrix.from_matrix(A), gt.CsrMatrix.from_matrix(B)
        Mc = gt.CsrMatrix.from_matrix(Mt) if M is not None else None
        C0 = gt.CsrMatrix.from_coo([], [], np.zeros(0, NPDT[tname]), 12, 11,
                                   device=CPU)
        got = gt.mxm(C0, Mc, None, tsr, Ac, Bc,
                     gt.Descriptor(axb_method="gustavson"))
        assert gt.last_axb_method() == "esc:csr_spgemm"
        got = got.to_matrix()
        assert np.array_equal(got.pattern_np(), wp)
        np.testing.assert_allclose(got.to_dense()[wp], wv[wp], **tol)
        if M is not None:
            assert tvd.build_valdot_plan(Mc, Ac, Bc, tsr, min_lanes=1) is None
            esc = tesc.csr_spgemm(tsr, Ac, Bc, mask=Mc)
            assert np.array_equal(esc.to_matrix().to_dense(),
                                  got.to_dense())


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("kind", ["csr", "bitmap"])
def test_mxv_matches_jax(tname, kind):
    rng = np.random.default_rng(8)
    Ad, Ap = _cdense(rng, 20, 15, 0.3, tname)
    x = (rng.normal(size=15) + 1j * rng.normal(size=15)).astype(NPDT[tname])
    jt, tt = getattr(gb, tname), getattr(gt, tname)
    want = gb.mxv(gb.Vector.new(jt, 20), None, None,
                  gb.semiring.plus_times[jt],
                  gb.Matrix.from_dense(Ad, jt, pattern=Ap),
                  gb.Vector.from_dense(x, jt))
    A = gt.Matrix.from_dense(Ad, tt, pattern=Ap, device=CPU)
    if kind == "csr":
        A = gt.CsrMatrix.from_matrix(A)
    got = gt.mxv(gt.Vector.new(tt, 20, device=CPU), None, None,
                 gt.semiring.plus_times[tt], A,
                 gt.Vector.from_dense(x, tt, device=CPU))
    wp = np.asarray(want.pattern)
    assert np.array_equal(got.pattern_np(), wp)
    np.testing.assert_allclose(got.to_dense()[wp],
                               np.asarray(want.to_dense())[wp],
                               rtol=RTOL[tname] * 10)
    if kind == "csr":
        assert gt.last_axb_method() == "spmv:dense_x"


@pytest.mark.parametrize("tname", CTYPES)
@pytest.mark.parametrize("kind", ["csr", "bitmap", "hyper"])
@pytest.mark.parametrize("op", ["plus", "times", "min", "div"])
def test_ewise_matches_jax(tname, kind, op):
    rng = np.random.default_rng(9)
    Ad, Ap = _cdense(rng, 8, 9, 0.5, tname)
    Bd, Bp = _cdense(rng, 8, 9, 0.5, tname)
    jt, tt = getattr(gb, tname), getattr(gt, tname)
    for jf, tf in ((gb.eWiseAdd, gt.eWiseAdd), (gb.eWiseMult,
                                                 gt.eWiseMult)):
        want = jf(gb.Matrix.new(jt, 8, 9), None, None, gb.binary[op][jt],
                  gb.Matrix.from_dense(Ad, jt, pattern=Ap),
                  gb.Matrix.from_dense(Bd, jt, pattern=Bp))
        A = gt.Matrix.from_dense(Ad, tt, pattern=Ap, device=CPU)
        B = gt.Matrix.from_dense(Bd, tt, pattern=Bp, device=CPU)
        C0 = gt.Matrix.new(tt, 8, 9, device=CPU)
        if kind == "csr":
            A, B = gt.CsrMatrix.from_matrix(A), gt.CsrMatrix.from_matrix(B)
            C0 = gt.CsrMatrix.from_matrix(C0)
        elif kind == "hyper":
            A, B = (gt.HyperMatrix.from_csr(gt.CsrMatrix.from_matrix(X))
                    for X in (A, B))
            C0 = gt.HyperMatrix.from_csr(gt.CsrMatrix.from_matrix(C0))
        got = tf(C0, None, None, gt.binary[op][tt], A, B)
        if kind == "hyper":
            got = got.to_csr()
        if kind != "bitmap":
            got = got.to_matrix()
        wp = np.asarray(want.pattern)
        assert np.array_equal(got.pattern_np(), wp)
        np.testing.assert_allclose(got.to_dense()[wp],
                                   np.asarray(want.to_dense())[wp],
                                   rtol=RTOL[tname])


@pytest.mark.parametrize("tname", CTYPES)
def test_from_jax_complex_containers(tname):
    """``from_jax`` carries FC32/FC64 containers, pending tuples
    included (with a builtin accum op)."""
    rng = np.random.default_rng(10)
    jt, tt = getattr(gb, tname), getattr(gt, tname)
    I, J = np.array([0, 1, 3]), np.array([2, 0, 3])
    X = (rng.normal(size=3) + 1j * rng.normal(size=3)).astype(NPDT[tname])
    Aj = JCsr.from_coo(I, J, X, 4, 4, type=jt)
    Aj = Aj.setElement(2 + 1j, 1, 0, accum=gb.binary.plus[jt])
    At = from_jax(Aj, device=CPU)
    assert At.type is tt and At.values.dtype == tt.storage
    Ij, Jj, Xj = Aj.wait().extractTuples()
    It, Jt, Xt = At.wait().extractTuples()
    assert np.array_equal(It, Ij) and np.array_equal(Jt, Jj)
    same_bits(Xt, np.asarray(Xj))
    Mj = gb.Matrix.from_dense(np.outer(X, X).astype(NPDT[tname]), jt)
    same_bits(from_jax(Mj, device=CPU).to_dense(),
              np.asarray(Mj.to_dense()))
    Hj = gb.sparse.HyperMatrix.from_coo(I, J, X, 4, 4, type=jt)
    same_bits(from_jax(Hj, device=CPU).extractTuples()[2],
              np.asarray(Hj.extractTuples()[2]))
