"""The port's native MatrixMarket parser (cgx_torch.io.native, its own
copy of cgx's C++ source) against cgx's (tests/test_native_mmio.py):
cgx's cases, each run on three readers (the port's native parser, cgx's,
and the NumPy parser), with cgx's error messages; the build into
build/cgx_torch/ under a source-hash name, safe when several processes
load a fresh build directory at once; and COOMatrix.read's routing.

No jax or cgx import at the top: the spawned loaders import this module.
"""

import multiprocessing
import os

import numpy as np
import pytest

from cgx_torch.io import mmio as port_mm
from cgx_torch.io import native
from cgx_torch.mats.containers import COOMatrix
from cgx_torch.mats.generators import lap2d_fd_coo_lower

READERS = ["port", "cgx", "numpy"]


def _reader(which: str):
    if which == "port":
        return native.mmread_native
    if which == "cgx":
        from cgx.io import native as cgx_native

        return cgx_native.mmread_native
    return port_mm.mmread


def _cgx_py():
    from cgx.io import mmio as cgx_mm

    return cgx_mm


@pytest.mark.parametrize("which", READERS)
def test_parity_symmetric(tmp_path, which):
    coo = lap2d_fd_coo_lower(20)
    path = tmp_path / "lap.mtx"
    coo.write(path, comment=" test")
    a = _cgx_py().mmread(path)
    b = _reader(which)(path)
    assert a.shape == b.shape and a.nnz == b.nnz
    assert b.typecode.is_symmetric
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("which", READERS)
def test_parity_general_random(tmp_path, which):
    rs = np.random.default_rng(0)
    n, nnz = 64, 500
    rows = rs.integers(0, n, nnz).astype(np.int32)
    cols = rs.integers(0, n, nnz).astype(np.int32)
    vals = rs.standard_normal(nnz) * 10.0 ** rs.integers(-300, 300, nnz)
    path = tmp_path / "g.mtx"
    port_mm.mmwrite(path, (n, n), rows, cols, vals)
    a = _cgx_py().mmread(path)
    b = _reader(which)(path)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.values, b.values)  # .17g round-trips


@pytest.mark.parametrize("which", READERS)
def test_pattern_and_integer(tmp_path, which):
    p1 = tmp_path / "p.mtx"
    p1.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n3 3 2\n1 1\n3 2\n"
    )
    d = _reader(which)(p1)
    assert d.typecode.is_pattern
    np.testing.assert_array_equal(d.rows, [0, 2])
    np.testing.assert_array_equal(d.values, [1.0, 1.0])

    p2 = tmp_path / "i.mtx"
    p2.write_text(
        "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 1 7\n2 2 -3\n"
    )
    d = _reader(which)(p2)
    np.testing.assert_array_equal(d.values, [7.0, -3.0])


@pytest.mark.parametrize("which", READERS)
def test_dense_array(tmp_path, which):
    p = tmp_path / "a.mtx"
    p.write_text("%%MatrixMarket matrix array real general\n2 3\n1\n4\n2\n5\n3\n6\n")
    d = _reader(which)(p)
    np.testing.assert_array_equal(d.dense, [[1, 2, 3], [4, 5, 6]])


@pytest.mark.parametrize("which", READERS)
@pytest.mark.parametrize(
    "content,msg",
    [
        ("junk\n1 1 1\n", "banner"),
        ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n", "truncated"),
        ("%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n", "bounds"),
        ("%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 zzz\n", "invalid"),
        ("%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 1.0\n9 9 9.0\n", "trailing"),
    ],
)
def test_errors(tmp_path, content, msg, which):
    """Each reader raises its package's MMIOError with cgx's message: the
    two native parsers the same text (naming the file), the NumPy parser
    cgx's NumPy parser's."""
    p = tmp_path / "bad.mtx"
    p.write_text(content)
    with pytest.raises(port_mm.MMIOError if which != "cgx" else _cgx_py().MMIOError) as got:
        _reader(which)(p)
    if which == "numpy":
        with pytest.raises(_cgx_py().MMIOError) as want:
            _cgx_py().mmread(p)
    else:
        from cgx.io import native as cgx_native

        with pytest.raises(_cgx_py().MMIOError) as want:
            cgx_native.mmread_native(p)
        assert msg in str(got.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("symmetric", [True, False])
def test_native_writer_roundtrip(tmp_path, symmetric):
    """The port's writer writes cgx's bytes, which every reader reads back."""
    from cgx.io import native as cgx_native

    coo = lap2d_fd_coo_lower(10)
    ours, theirs = tmp_path / "w.mtx", tmp_path / "c.mtx"
    for write, path in ((native.mmwrite_native, ours), (cgx_native.mmwrite_native, theirs)):
        write(path, coo.shape, coo.rows, coo.cols, coo.values, symmetric=symmetric,
              comment=" x")
    assert ours.read_bytes() == theirs.read_bytes()
    back = port_mm.mmread(ours)
    assert back.typecode.is_symmetric == symmetric
    np.testing.assert_array_equal(back.rows, coo.rows)
    np.testing.assert_array_equal(back.values, coo.values)


def test_auto_dispatch(tmp_path, monkeypatch):
    """mmread_auto agrees with the NumPy reader on either path: the
    native parser from 1 MiB on, the NumPy one below it and under
    CGX_NO_NATIVE; COOMatrix.read goes through it."""
    calls = []
    real = native.mmread_native
    monkeypatch.setattr(native, "mmread_native", lambda p: (calls.append(p), real(p))[1])
    small = tmp_path / "small.mtx"
    lap2d_fd_coo_lower(30).write(small)
    big = tmp_path / "big.mtx"
    lap2d_fd_coo_lower(180).write(big)
    assert os.path.getsize(small) < 1 << 20 <= os.path.getsize(big)
    for path in (small, big):
        d, e = native.mmread_auto(path), port_mm.mmread(path)
        np.testing.assert_array_equal(d.rows, e.rows)
        np.testing.assert_array_equal(d.values, e.values)
    assert calls == [big]
    monkeypatch.setenv("CGX_NO_NATIVE", "1")
    assert not native.native_available()
    native.mmread_auto(big)
    assert calls == [big]
    monkeypatch.delenv("CGX_NO_NATIVE")
    coo = COOMatrix.read(big)
    assert calls == [big, big] and coo.symmetric and coo.shape == (32400, 32400)
    np.testing.assert_array_equal(coo.values, port_mm.mmread(big).values)


def test_build_goes_to_build_dir_by_source_hash():
    assert native.native_available()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libcgxmmio_") and path.suffix == ".so"
    assert native.SOURCE.parent.name == "_native" and native.SOURCE.parent.parent.name == \
        "cgx_torch"
    assert not list(native.SOURCE.parent.glob("*.so"))  # nothing built beside the source


def _load_at_once(build_dir, mtx, barrier, out):
    """One of several processes that build and load a fresh directory at once."""
    native.BUILD_DIR = build_dir
    barrier.wait(timeout=60)
    ok = native.native_available()
    d = native.mmread_native(mtx) if ok else None
    out.put((ok, None if d is None else (d.nnz, float(d.values.sum()))))


def test_concurrent_loaders_each_get_a_whole_library(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    mtx = tmp_path / "lap.mtx"
    coo = lap2d_fd_coo_lower(40)
    coo.write(mtx)
    build_dir = tmp_path / "fresh_build"
    barrier, out = ctx.Barrier(3), ctx.Queue()
    procs = [ctx.Process(target=_load_at_once, args=(build_dir, str(mtx), barrier, out))
             for _ in range(3)]
    for p in procs:
        p.start()
    results = [out.get(timeout=180) for _ in procs]  # drain before joining
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert results == [(True, (len(coo.values), float(coo.values.sum())))] * 3
    libs = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert len(libs) == 1 and not [f for f in os.listdir(build_dir) if f.endswith(".tmp")]
