"""PyTorch port: triplet/MatrixMarket IO and ``.npz`` checkpoints
(``io/read.py``, ``io/checkpoint.py``), against the JAX package.

``write_triplets`` must write the JAX package's bytes for every type;
``read_triplets``, ``read_matrix``, ``mmread`` and ``get_matrix`` must
give the same arrays and matrices (exact: patterns, integers and the
float64 values the parser and the dup sums produce, which both packages
form in the same order); ``.npz`` archives written by either package
must load in the other, struct-typed archives included.
"""

import io

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu import io as jio
from graphblas_tpu import sparse as jsp
from graphblas_tpu_torch import io as tio
from graphblas_tpu_torch import sparse as tsp

DEV = "cpu"
TYPES = ["BOOL", "INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32",
         "INT64", "UINT64", "FP32", "FP64", "FC32", "FC64"]


def _same_matrix(Mt, Mj):
    assert Mt.shape == tuple(Mj.shape) and Mt.type.name == Mj.type.name
    It, Jt, Xt = Mt.extractTuples()
    Ij, Jj, Xj = Mj.extractTuples()
    np.testing.assert_array_equal(It, np.asarray(Ij))
    np.testing.assert_array_equal(Jt, np.asarray(Jj))
    np.testing.assert_array_equal(Xt, np.asarray(Xj))


def _rand_entries(name, seed, shape=(9, 11), density=0.4):
    rng = np.random.default_rng(seed)
    pat = rng.random(shape) < density
    I, J = np.nonzero(pat)
    v = rng.normal(size=len(I)) * 1e3
    if name.startswith("FC"):
        v = v + 1j * rng.normal(size=len(I)) / 7
    if name.startswith("U") or name == "BOOL":
        v = np.abs(v)
    return I, J, v.astype(getattr(gb, name).dtype)


@pytest.mark.parametrize("one_based", [False, True])
@pytest.mark.parametrize("name", TYPES)
def test_write_triplets_bytes_match_jax(tmp_path, name, one_based):
    I, J, X = _rand_entries(name, TYPES.index(name))
    tj, tt = getattr(gb, name), getattr(gt, name)
    pj, pt, pc = (tmp_path / f"{k}.tsv" for k in ("j", "t", "c"))
    jio.write_triplets(pj, gb.Matrix.from_coo(I, J, X, 9, 11, type=tj),
                       one_based=one_based)
    tio.write_triplets(pt, gt.Matrix.from_coo(I, J, X, 9, 11, type=tt,
                                              device=DEV),
                       one_based=one_based)
    tio.write_triplets(pc, tsp.CsrMatrix.from_coo(I, J, X, 9, 11, type=tt,
                                                  device=DEV),
                       one_based=one_based)
    assert pt.read_bytes() == pj.read_bytes()
    assert pc.read_bytes() == pj.read_bytes()


def test_write_triplets_chunks(tmp_path, monkeypatch):
    """Chunked formatting joins to the same file."""
    from graphblas_tpu_torch.io import read as tread
    I, J, X = _rand_entries("FP64", 3)
    M = gt.Matrix.from_coo(I, J, X, 9, 11, device=DEV)
    tio.write_triplets(tmp_path / "a.tsv", M)
    monkeypatch.setattr(tread, "_WRITE_CHUNK", 7)
    tio.write_triplets(tmp_path / "b.tsv", M)
    assert (tmp_path / "a.tsv").read_bytes() == \
        (tmp_path / "b.tsv").read_bytes()


TRIPLET_TEXTS = {
    "three_columns": "0 1 2.5\n1 0 -3\n2 2 1e-3\n",
    "tabs_and_comments": "% header\n# note\n0\t1\t2.5\n\n3\t0\t7\n",
    "mixed_columns": "0 1\n1 2 4.5\n2 0 1.5 extra tokens\n",
    "trailing_comment": "0 1 2 % a comment\n1 1 3 # another\n",
    "duplicates": "0 1 1\n0 1 2\n1 0 5\n0 1 0.25\n",
    "empty": "% nothing here\n",
}


@pytest.mark.parametrize("key", sorted(TRIPLET_TEXTS))
def test_read_triplets_matches_jax(tmp_path, key):
    text = TRIPLET_TEXTS[key]
    path = tmp_path / "g.tsv"
    path.write_text(text)
    for src in (str(path), lambda: io.StringIO(text)):
        got = tio.read_triplets(src() if callable(src) else src)
        want = jio.read_triplets(src() if callable(src) else src)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_read_triplets_malformed_raises():
    for text in ("0\n", "0 x 1\n"):
        with pytest.raises(ValueError):
            jio.read_triplets(io.StringIO(text))
        with pytest.raises(ValueError):
            tio.read_triplets(io.StringIO(text))


@pytest.mark.parametrize("make_symmetric", [False, True])
@pytest.mark.parametrize("no_self_edges", [False, True])
@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", ["square", "rect"])
def test_read_matrix_matches_jax(tmp_path, make_symmetric, no_self_edges,
                                 boolean, shape):
    rng = np.random.default_rng(11)
    m, n = (12, 12) if shape == "square" else (7, 12)
    I, J = rng.integers(0, m, 60), rng.integers(0, n, 60)
    I[:3], J[:3] = [0, 1, 2], [0, 1, 2]            # self edges
    X = np.round(rng.normal(size=60), 3)
    path = tmp_path / "g.tsv"
    path.write_text("".join(f"{i} {j} {x}\n" for i, j, x in zip(I, J, X)))
    kw = dict(make_symmetric=make_symmetric, no_self_edges=no_self_edges,
              boolean=boolean)
    _same_matrix(tio.read_matrix(path, device=DEV, **kw),
                 jio.read_matrix(path, **kw))


def test_read_matrix_one_based_and_dims(tmp_path):
    path = tmp_path / "g.tsv"
    path.write_text("1 2 3\n4 1 5\n")
    _same_matrix(tio.read_matrix(path, one_based=True, nrows=6, ncols=5,
                                 device=DEV),
                 jio.read_matrix(path, one_based=True, nrows=6, ncols=5))


MM_TEXTS = {
    "general": ("%%MatrixMarket matrix coordinate real general\n"
                "% comment\n3 4 4\n1 1 2.5\n2 3 -1\n3 4 4\n1 1 0.5\n"),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "4 4 4\n1 1 1\n2 1 2\n3 2 3\n4 1 4\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "3 3 3\n1 2\n2 3\n3 1\n"),
    "empty": "%%MatrixMarket matrix coordinate real general\n2 2 0\n",
}


@pytest.mark.parametrize("key", sorted(MM_TEXTS))
def test_mmread_matches_jax(tmp_path, key):
    path = tmp_path / "m.mtx"
    path.write_text(MM_TEXTS[key])
    _same_matrix(tio.mmread(path, device=DEV), jio.mmread(path))
    _same_matrix(tio.mmread(io.StringIO(MM_TEXTS[key]), device=DEV),
                 jio.mmread(io.StringIO(MM_TEXTS[key])))


@pytest.mark.parametrize("kw", [
    dict(nx=3, ny=2),
    dict(nx=4, ny=4, method=0),
    dict(random=True, nrows=30, ncols=20, ntuples=90, seed=3),
    dict(random=True, nrows=25, ncols=25, ntuples=80, seed=4,
         make_symmetric=True, no_self_edges=True, boolean=True),
])
def test_get_matrix_matches_jax(kw):
    _same_matrix(tio.get_matrix(device=DEV, **kw), jio.get_matrix(**kw))


def test_get_matrix_from_file_matches_jax(tmp_path):
    path = tmp_path / "g.tsv"
    path.write_text("0 1 1\n1 2 1\n2 0 1\n2 2 1\n")
    kw = dict(make_symmetric=True, no_self_edges=True, boolean=True)
    _same_matrix(tio.get_matrix(path, device=DEV, **kw),
                 jio.get_matrix(path, **kw))


def test_entry_points_need_a_device_without_a_card(tmp_path, monkeypatch):
    """Without a card and without ``device`` the readers raise, like the
    constructors (they never fall back to the CPU)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "g.tsv"
    path.write_text("0 1 1\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.read_matrix(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.get_matrix(nx=2, ny=2)
    M = gt.Matrix.from_coo([0], [1], [1.0], 2, 2, device=DEV)
    tio.save_matrix(tmp_path / "a.npz", M)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_matrix(tmp_path / "a.npz")


@pytest.mark.parametrize("name", TYPES)
def test_npz_archives_cross_packages(tmp_path, name):
    I, J, X = _rand_entries(name, 20 + TYPES.index(name))
    tj, tt = getattr(gb, name), getattr(gt, name)
    Mj = gb.Matrix.from_coo(I, J, X, 9, 11, type=tj)
    Mt = gt.Matrix.from_coo(I, J, X, 9, 11, type=tt, device=DEV)
    Ct = tsp.CsrMatrix.from_coo(I, J, X, 9, 11, type=tt, device=DEV)
    tio.save_matrix(tmp_path / "t.npz", Mt)
    tio.save_matrix(tmp_path / "c.npz", Ct)
    jio.save_matrix(tmp_path / "j.npz", Mj)
    for f in ("t.npz", "c.npz", "j.npz"):
        _same_matrix(tio.load_matrix(tmp_path / f, device=DEV), Mj)
        _same_matrix(jio.load_matrix(tmp_path / f), Mj)
        C = tio.load_matrix(tmp_path / f, as_csr=True, device=DEV)
        assert isinstance(C, tsp.CsrMatrix) and gt.check(C)
        _same_matrix(C.to_matrix(), Mj)
    vj = gb.Vector.from_coo(I, X, 9, type=tj, dup=gb.binary.first[tj])
    vt = gt.Vector.from_coo(I, X, 9, type=tt, dup=gt.binary.first[tt],
                            device=DEV)
    tio.save_vector(tmp_path / "vt.npz", vt)
    jio.save_vector(tmp_path / "vj.npz", vj)
    for f in ("vt.npz", "vj.npz"):
        for a, b in zip(tio.load_vector(tmp_path / f,
                                        device=DEV).extractTuples(),
                        jio.load_vector(tmp_path / f).extractTuples()):
            np.testing.assert_array_equal(a, np.asarray(b))


def _struct_types():
    inner = ("inner", dict(a="FP64", b="FP32"))
    return (gb.Type.udt("pt", a=gb.FP64, b=gb.INT32,
                        c=gb.Type.udt(inner[0], a=gb.FP64, b=gb.FP32)),
            gt.Type.udt("pt", a=gt.FP64, b=gt.INT32,
                        c=gt.Type.udt(inner[0], a=gt.FP64, b=gt.FP32)))


def test_npz_struct_archives_cross_packages(tmp_path):
    """A struct archive (``field.<path>`` keys, a nested field included)
    written by either package loads in the other, as a bitmap Matrix
    or, in the port, as a CSR container too."""
    Uj, Ut = _struct_types()
    rng = np.random.default_rng(9)
    entries = [(0, 1), (2, 0), (3, 3), (1, 2)]
    vals = [{"a": float(rng.normal()), "b": int(rng.integers(-99, 99)),
             "c": {"a": float(rng.normal()), "b": float(rng.normal())}}
            for _ in entries]
    Mj = gb.Matrix.new(Uj, 4, 5)
    Mt = gt.Matrix.new(Ut, 4, 5, device=DEV)
    for (i, j), x in zip(entries, vals):
        Mj = Mj.setElement(x, i, j)
        Mt = Mt.setElement(x, i, j)
    jio.save_matrix(tmp_path / "j.npz", Mj)
    tio.save_matrix(tmp_path / "t.npz", Mt)
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k])
    for f in ("j.npz", "t.npz"):
        Nj = jio.load_matrix(tmp_path / f, type=Uj)
        Nt = tio.load_matrix(tmp_path / f, type=Ut, device=DEV)
        Ct = tio.load_matrix(tmp_path / f, type=Ut, as_csr=True, device=DEV)
        assert Nt.nvals() == Nj.nvals() == Ct.nvals == len(entries)
        for (i, j), x in zip(entries, vals):
            want = Nj.extractElement(i, j)
            for got in (Nt.extractElement(i, j), Ct.extractElement(i, j)):
                assert got["a"] == want["a"] == np.float64(x["a"])
                assert got["b"] == want["b"] == x["b"]
                assert got["c"] == want["c"]
    with pytest.raises(ValueError):
        tio.load_matrix(tmp_path / "t.npz", device=DEV)


def test_struct_csr_archive_roundtrip(tmp_path):
    """A struct CSR container saves from its tuples and loads back as
    CSR with the same arrays, field by field."""
    U = gt.Type.udt("ab", a=gt.FP64, b=gt.INT32)
    rng = np.random.default_rng(2)
    I, J = np.nonzero(rng.random((30, 40)) < 0.2)
    X = {"a": rng.normal(size=len(I)),
         "b": rng.integers(-5, 5, len(I)).astype(np.int32)}
    C = tsp.CsrMatrix.from_coo(I, J, X, 30, 40, type=U, device=DEV)
    tio.save_matrix(tmp_path / "s.npz", C)
    D = tio.load_matrix(tmp_path / "s.npz", type=U, as_csr=True, device=DEV)
    for a, b in zip(C.extractTuples()[:2], D.extractTuples()[:2]):
        np.testing.assert_array_equal(a, b)
    for k in ("a", "b"):
        np.testing.assert_array_equal(C.extractTuples()[2][k],
                                      D.extractTuples()[2][k])
