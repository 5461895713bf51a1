"""cgx_torch's NumPy copies of the cgx containers, generators and
MatrixMarket I/O agree with cgx's, element for element."""

import io

import numpy as np
import pytest

import cgx.io.mmio as cgx_mmio
import cgx.mats.containers as cgx_cont
import cgx.mats.generators as cgx_gen
import cgx_torch.io.mmio as ct_mmio
import cgx_torch.mats.containers as ct_cont
import cgx_torch.mats.generators as ct_gen


def _coeff(shape, seed=3):
    return np.exp(np.random.default_rng(seed).uniform(-2, 2, size=shape))


GENERATORS = [
    ("lap2d_reference", (256,)),
    ("lap2d_reference", (1000,)),  # not a square: inc = 31
    ("lap2d_fd", (8,)),
    ("lap2d_fd", (17,)),
    ("lap3d_fd", (5,)),
    ("lap2d_aniso", (9, 0.1)),
    ("poisson2d_var", (7, _coeff((7, 7)))),
    ("poisson3d_var", (4, _coeff((4, 4, 4)))),
]


@pytest.mark.parametrize("name,args", GENERATORS, ids=[g[0] + str(g[1][0]) for g in GENERATORS])
def test_generator_matches_cgx(name, args):
    want = getattr(cgx_gen, name)(*args)
    got = getattr(ct_gen, name)(*args)
    assert isinstance(got, ct_cont.DIAMatrix)
    assert got.shape == want.shape
    assert tuple(got.offsets) == tuple(want.offsets)
    np.testing.assert_array_equal(got.bands, want.bands)


@pytest.mark.parametrize("n,h", [(100, None), (1000, None), (64, 0.01)])
def test_source_term_matches_cgx(n, h):
    np.testing.assert_array_equal(ct_gen.source_term(n, h), cgx_gen.source_term(n, h))


@pytest.mark.parametrize("fmt", ["coo", "dense", "csr", "ell", "dia"])
def test_containers_match_cgx(fmt):
    cgx_coo, ct_coo = cgx_gen.lap2d_fd_coo_lower(6), ct_gen.lap2d_fd_coo_lower(6)
    x = np.random.default_rng(1).standard_normal(36)
    if fmt == "coo":
        for field in ("rows", "cols", "values"):
            np.testing.assert_array_equal(getattr(ct_coo, field), getattr(cgx_coo, field))
        assert ct_coo.symmetric and cgx_coo.symmetric
        np.testing.assert_array_equal(ct_coo.mat_vec(x), cgx_coo.mat_vec(x))
        return
    if fmt == "dense":
        np.testing.assert_array_equal(ct_coo.to_dense(), cgx_coo.to_dense())
        return
    cls = {"csr": "CSRMatrix", "ell": "ELLMatrix", "dia": "DIAMatrix"}[fmt]
    want = getattr(cgx_cont, cls).from_coo(cgx_coo)
    got = getattr(ct_cont, cls).from_coo(ct_coo)
    np.testing.assert_array_equal(got.mat_vec(x), want.mat_vec(x))
    for field in ("indptr", "indices", "values", "bands", "offsets"):
        if hasattr(want, field):
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          np.asarray(getattr(want, field)))


def test_dia_from_coo_reproduces_generator():
    dia = ct_cont.DIAMatrix.from_coo(ct_gen.lap2d_fd_coo_lower(9))
    want = ct_gen.lap2d_fd(9)
    assert tuple(dia.offsets) == tuple(want.offsets)
    np.testing.assert_array_equal(dia.bands, want.bands)
    np.testing.assert_array_equal(dia.to_dense(), want.to_dense())


def test_mtx_round_trip(tmp_path):
    """The port writes lap2d_fd_coo_lower(10); both packages read it back
    identically, and it expands to the generator's matrix."""
    path = tmp_path / "lap2D_5pt_n10.mtx"
    ct_gen.lap2d_fd_coo_lower(10).write(str(path), comment="cgx_torch round trip")
    got = ct_cont.COOMatrix.read(str(path))
    want = cgx_cont.COOMatrix.read(str(path))
    assert got.shape == want.shape and got.symmetric == want.symmetric
    for field in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.to_dense(), ct_gen.lap2d_fd(10).to_dense())


@pytest.mark.parametrize(
    "text",
    [
        "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
        "%%MatrixMarket matrix coordinate pattern general\n% c\n3 3 2\n1 1\n3 2\n",
    ],
)
def test_mmread_matches_cgx(text):
    got, want = ct_mmio.mmread(io.StringIO(text)), cgx_mmio.mmread(io.StringIO(text))
    assert got.typecode.banner() == want.typecode.banner()
    assert (got.shape, got.nnz) == (want.shape, want.nnz)
    for field in ("rows", "cols", "values", "dense"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_mmread_rejects_what_cgx_rejects():
    bad = "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n"
    with pytest.raises(ct_mmio.MMIOError):
        ct_mmio.mmread(io.StringIO(bad))
    with pytest.raises(cgx_mmio.MMIOError):
        cgx_mmio.mmread(io.StringIO(bad))
