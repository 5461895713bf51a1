"""The work counts reproduce the bounds that PERF.md's kernel table gives
at its shapes, and the table of peaks finds the H100."""

import pytest

from cgbench import roofline, spec

H100 = roofline.card("NVIDIA H100 80GB HBM3")
N_MAIN, N_RESIDENT, NDIAG = 10_240_000, 1_000_000, 5


def test_the_h100_entry():
    assert H100["hbm_bytes_per_s"] == 3.35e12 and H100["flops_per_s"]["float32"] == 67e12
    # another card's rates differ: it gets no roofline until its own entry is added
    assert roofline.card("NVIDIA H100 NVL") is None and roofline.card("NVIDIA H100 PCIe") is None
    assert roofline.card("some other card") is None


@pytest.mark.parametrize("method, kw, iters, ms, by", [
    # B4: an iteration of the streaming kernel, bf16 bands, float32 vectors
    ("cg_stream", dict(band_bytes=2), 1, 0.1528, "bytes"),
    # B6: the streaming PCG, float32 bands
    ("pcg_stream", dict(band_bytes=4), 1, 0.2079, "bytes"),
])
def test_stream_bounds(method, kw, iters, ms, by):
    count = spec.load_module("work", method).count(N_MAIN, NDIAG, iters, 1, **kw)
    t, bound_by = roofline.least_seconds(count, H100)
    assert t * 1e3 == pytest.approx(ms, abs=5e-5) and bound_by == by


def test_resident_bound_of_a_64_iteration_chunk():
    # B5: one launch of 64 iterations at N = 1e6, float32 bands and vectors
    count = spec.load_module("work", "cg_resident").count(N_RESIDENT, NDIAG, 64, 1, band_bytes=4)
    t, by = roofline.least_seconds(count, H100)
    assert t * 1e3 == pytest.approx(0.0228, abs=5e-5) and by == "operations"


def test_counts_scale_with_the_iterations():
    for method in ("cg_stream", "pcg_stream", "cg_resident"):
        w = spec.load_module("work", method)
        one, ten = (w.count(1000, NDIAG, it, 1, band_bytes=2) for it in (1, 10))
        assert ten["ops"] == {k: 10 * v for k, v in one["ops"].items()}
    res = spec.load_module("work", "cg_resident")
    assert res.count(1000, NDIAG, 10, 1, band_bytes=2)["bytes"] == \
        res.count(1000, NDIAG, 1, 1, band_bytes=2)["bytes"]
