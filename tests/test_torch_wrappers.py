"""cgx_torch's kernel wrappers: their CPU dispatch and input checks,
and, on a card only, each CUDA kernel against its plain version.

This file imports no JAX, so the CUDA cases run on a machine without
it: ``python -m pytest tests/test_torch_wrappers.py --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch.mats.generators import lap2d_fd, lap2d_reference, source_term
from cgx_torch.ops import axpy, dia_spmv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_calls(n=600, dtype=torch.float64, device="cpu", seed=0):
    """One call of each wrapper and of its plain version, on seeded inputs."""
    dia = lap2d_reference(n)
    offs = tuple(dia.offsets)
    g = np.random.default_rng(seed)
    bands = torch.as_tensor(dia.bands, dtype=dtype, device=device)
    x, p, r, ap = (torch.as_tensor(g.standard_normal(n), dtype=dtype, device=device)
                   for _ in range(4))
    alpha = torch.tensor(0.37, dtype=dtype, device=device)
    one = torch.tensor(1.0, dtype=dtype, device=device)
    return {
        "dia_matvec": (lambda: dia_spmv.dia_matvec(bands, x, offsets=offs),
                       lambda: dia_spmv.dia_matvec_ref(bands, x, offsets=offs)),
        "dia_matvec_dot": (lambda: dia_spmv.dia_matvec_dot(bands, x, offsets=offs),
                           lambda: dia_spmv.dia_matvec_dot_ref(bands, x, offsets=offs)),
        "fused_update_rs": (lambda: axpy.fused_update_rs(x, p, r, ap, alpha),
                            lambda: axpy.fused_update_rs_ref(x, p, r, ap, alpha)),
        "fused_axpby": (lambda: axpy.fused_axpby(p, r, alpha, one),
                        lambda: axpy.fused_axpby_ref(p, r, alpha, one)),
    }


WRAPPERS = {
    "dia_matvec": dia_spmv.dia_matvec,
    "dia_matvec_dot": dia_spmv.dia_matvec_dot,
    "fused_update_rs": axpy.fused_update_rs,
    "fused_axpby": axpy.fused_axpby,
}


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_cpu_counts_and_runs_plain(name, monkeypatch):
    """On a CPU tensor a wrapper counts one launch and returns exactly
    its plain version's result, without building any kernel."""
    import cgx_torch._build as build

    def no_build():
        raise AssertionError("a CPU call must not build the CUDA kernels")

    monkeypatch.setattr(build, "load", no_build)
    kern, plain = _kernel_calls()[name]
    before = WRAPPERS[name].launches
    got = _as_tuple(kern())
    assert WRAPPERS[name].launches == before + 1
    for g, w in zip(got, _as_tuple(plain())):
        assert torch.equal(g, w)


def test_wrappers_reject_bad_operands():
    x = torch.zeros(8, dtype=torch.float64)
    bands = torch.zeros(3, 8, dtype=torch.float64)
    one = torch.ones((), dtype=torch.float64)
    with pytest.raises(TypeError):  # dtype the kernels do not take
        dia_spmv.dia_matvec(bands.half(), x.half(), offsets=(-1, 0, 1))
    with pytest.raises(ValueError):  # bands do not match the offsets
        dia_spmv.dia_matvec(bands, x, offsets=(0, 1))
    with pytest.raises(ValueError):  # more diagonals than the kernel holds
        dia_spmv.dia_matvec_dot(torch.zeros(17, 8, dtype=torch.float64), x,
                                offsets=tuple(range(17)))
    with pytest.raises(ValueError):  # lengths differ
        axpy.fused_axpby(x, torch.zeros(9, dtype=torch.float64), one, one)
    with pytest.raises(TypeError):  # mixed dtypes
        axpy.fused_update_rs(x, x, x, x.float(), one)
    with pytest.raises(TypeError):  # a host float where a device scalar belongs
        axpy.fused_axpby(x, x, 1.0, one)
    with pytest.raises(ValueError):  # strided vector
        axpy.fused_axpby(torch.zeros(16, dtype=torch.float64)[::2], x, one, one)
    with pytest.raises(ValueError):  # a device the kernels do not run on
        axpy.fused_axpby(x.to("meta"), x.to("meta"), one.to("meta"), one.to("meta"))


# --- on the card only --------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [600, 300_000])  # one block-row, and the grid-stride loop
def test_cuda_kernels_match_plain(cuda, dtype, n):
    """Built with -fmad=false, each kernel's vectors equal its plain
    version's bit for bit; the dots differ only in summation order."""
    for name, (kern, plain) in _kernel_calls(n, dtype, cuda).items():
        got, want = _as_tuple(kern()), _as_tuple(plain())
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dim() == 1:
                assert torch.equal(g, w), name
            else:
                tol = 1e-5 if dtype == torch.float32 else 1e-12
                assert abs(float(g) - float(w)) <= tol * float(w.abs()) + 1e-30, name


@pytest.mark.cuda
def test_cuda_dots_are_deterministic(cuda):
    calls = _kernel_calls(300_000, torch.float32, cuda)
    for name in ("dia_matvec_dot", "fused_update_rs"):
        first = _as_tuple(calls[name][0]())[-1]
        for _ in range(5):
            assert torch.equal(_as_tuple(calls[name][0]())[-1], first), name


@pytest.mark.cuda
def test_cuda_fast_loop_golden_and_repeatable(cuda):
    """The fp64 golden lap2d_fd(100) at tol 1e-10 through the kernels
    (k in [485, 491]), and two solves bitwise equal."""
    dia = lap2d_fd(100)
    b = source_term(dia.shape[0])
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    first = cgx_torch.dia_cg_solve_pallas(op, b, tol=1e-10, history=8, device=cuda)
    again = cgx_torch.dia_cg_solve_pallas(op, b, tol=1e-10, history=8, device=cuda)
    assert bool(first.converged) and 485 <= int(first.iterations) <= 491
    assert int(again.iterations) == int(first.iterations)
    assert torch.equal(first.x.view(torch.int64), again.x.view(torch.int64))
    x = first.x.cpu().numpy()
    assert np.linalg.norm(dia.mat_vec(x) - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.cuda
def test_cuda_inputs_must_share_the_device(cuda):
    dia = lap2d_fd(8)
    op = cgx_torch.as_operator(dia, torch.float64, device=cuda)
    with pytest.raises(ValueError):
        cgx_torch.dia_cg_solve_pallas(op, torch.ones(64, dtype=torch.float64), device=cuda)
    with pytest.raises(ValueError):
        dia_spmv.dia_matvec(op.bands, torch.ones(64, dtype=torch.float64), offsets=op.offsets)
