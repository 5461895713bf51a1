"""cgx_torch stands alone: it imports neither JAX nor cgx, builds no
kernel at import, and runs its solver loops at full float32."""

import inspect
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import cgx_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
# an import statement that names jax or the cgx package (cgx_torch is fine)
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|cgx)(\s|\.|,|$)", re.M)


def test_import_pulls_in_neither_jax_nor_cgx():
    code = ("import cgx_torch, sys; "
            "assert 'jax' not in sys.modules and 'cgx' not in sys.modules, "
            "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cgx'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["cgx_torch.cli.main", "cgx_torch.ops.matvec",
                                    "cgx_torch.ops.cg_kernel", "cgx_torch.solver.refine",
                                    "cgx_torch.ops.cg_stream", "cgx_torch.solver.pipelined",
                                    "cgx_torch.ops.dia_powers", "cgx_torch.ops.sstep_stream",
                                    "cgx_torch.solver.sstep", "cgx_torch.solver.chebyshev",
                                    "cgx_torch.ops.tw32", "cgx_torch.ops.dd",
                                    "cgx_torch.ops.ozaki", "cgx_torch.parallel",
                                    "cgx_torch.parallel.sharded_cg",
                                    "cgx_torch.parallel.sstep_fused",
                                    "cgx_torch.parallel.mg_sharded",
                                    "cgx_torch.parallel.tw_sharded",
                                    "cgx_torch.parallel.multihost",
                                    "cgx_torch.parallel.batched2d",
                                    "cgx_torch.utils.collectives",
                                    "cgx_torch.solver.multigrid", "cgx_torch.solver.precond",
                                    "cgx_torch.mats.device", "cgx_torch.solver.gvpipe",
                                    "cgx_torch.solver.batched", "cgx_torch.solver.blockcg",
                                    "cgx_torch.solver.deflated", "cgx_torch.solver.autodiff",
                                    "cgx_torch.solver.api", "cgx_torch.utils.checkpoint",
                                    "cgx_torch.utils.records", "cgx_torch.utils.timer",
                                    "cgx_torch.bench", "cgx_torch.bench.slope",
                                    "cgx_torch.bench.autotune", "cgx_torch.bench.sweeps",
                                    "cgx_torch.bench.tenancy", "cgx_torch.bench.analysis",
                                    "cgx_torch.bench.report", "cgx_torch.io.native"])
def test_module_import_pulls_in_neither_jax_nor_cgx_nor_a_build(module):
    code = (f"import {module}, sys, cgx_torch; "
            "assert 'jax' not in sys.modules and 'cgx' not in sys.modules, "
            "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cgx')); "
            "assert not cgx_torch._build.load.cache_info().currsize")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# cgx's public names with no counterpart in the port, each JAX- or TPU-only
NOT_PORTED = {
    "cgx.config.enable_x64": "JAX's x64 switch; torch has float64 without one",
    "cgx.config.default_dtype": "the float JAX's x64 switch allows",
    "cgx.config.VMEM_BUDGET_BYTES": "the TPU's VMEM budget (the port's: RESIDENT_BUDGET_BYTES)",
    "cgx.ops._util.no_x64_trace": "a JAX trace without x64",
    "cgx.ops._util.LANES": "the TPU's lane width",
    "cgx.ops._util.sublanes": "the TPU's sublane tiling of a dtype",
    "cgx.ops._util.flat_shift": "a lane-roll of the TPU's (rows, lanes) layout",
    "cgx.ops._util.plane_shifts": "lane-roll shifts of the TPU's plane layout",
    "cgx.ops._util.plane_matvec": "the banded product on the TPU's plane layout",
    "cgx.ops.cg_kernel.LANES": "the TPU's lane width",
    "cgx.ops.cg_kernel.VMEM_BUDGET_BYTES": "the TPU's VMEM budget",
    "cgx.ops.cg_kernel.vmem2d_scoped_bytes": "the TPU kernel's scoped VMEM (the port's: "
                                             "resident_state_bytes)",
    "cgx.solver.api.VMEM_BUDGET_BYTES": "the TPU's VMEM budget",
    "cgx.bench.sweeps.VMEM_BUDGET_BYTES": "the TPU's VMEM budget (the port asks dense_plan)",
    "cgx.solver.operators.banded_matvec": "DiaOperator.matvec here (ops.dia_spmv.dia_matvec_ref)",
    "cgx.solver.operators.banded_matvec_blocked": "blocks sized for the TPU's VMEM",
    "cgx.parallel.mesh.row_sharding": "a JAX NamedSharding helper",
    "cgx.parallel.mesh.col_sharding": "a JAX NamedSharding helper",
    "cgx.parallel.mesh.band_sharding": "a JAX NamedSharding helper",
    "cgx.parallel.mesh.replicated": "a JAX NamedSharding helper",
    "cgx.utils.collectives.collective_signature": "walks a traced jaxpr (the port records "
                                                  "what ran: capture)",
    "cgx.utils.collectives.reduction_feeds_collective": "walks a traced jaxpr",
    "cgx.utils.collectives.collective_critical_depth": "walks a traced jaxpr",
    "cgx.utils.collectives.run_recorded": "records a jitted program and its arguments",
    "cgx.utils.collectives.REDUCTIONS": "jaxpr primitive names",
    "cgx.utils.collectives.OTHER_COLLECTIVES": "jaxpr primitive names",
    "cgx.utils.collectives.COLLECTIVES": "jaxpr primitive names",
}


def _public_names(mod) -> list:
    """The functions and classes a module defines, and its upper-case
    constants (not classes, functions or modules it imports)."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            if getattr(obj, "__module__", None) == mod.__name__:
                out.append(name)
        elif name.isupper() and not inspect.ismodule(obj):
            out.append(name)
    return out


def test_every_public_name_of_cgx_has_a_counterpart():
    """Module for module and name for name, cgx_torch has what cgx has,
    but for NOT_PORTED's JAX- and TPU-only helpers."""
    import importlib

    missing, exempt_used = [], set()
    for f in sorted((ROOT / "cgx").rglob("*.py")):
        parts = list(f.relative_to(ROOT / "cgx").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mod = importlib.import_module(".".join(["cgx", *parts]))
        port = importlib.import_module(".".join(["cgx_torch", *parts]))
        for name in _public_names(mod):
            key = f"{mod.__name__}.{name}"
            if key in NOT_PORTED:
                exempt_used.add(key)
            elif not hasattr(port, name):
                missing.append(key)
    assert not missing, missing
    assert exempt_used == set(NOT_PORTED), set(NOT_PORTED) - exempt_used


def test_sources_import_neither_jax_nor_cgx():
    files = sorted((ROOT / "cgx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_import_builds_no_kernel():
    code = ("import cgx_torch, cgx_torch.ops.dia_spmv, cgx_torch.ops.axpy, sys; "
            "import cgx_torch.parallel.sharded_cg; "
            "assert not cgx_torch._build.load.cache_info().currsize; "
            "assert 'ctypes' not in sys.modules or not cgx_torch._build.load.cache_info().hits")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def _flag_recorder(seen):
    def matvec(v):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()))
        return 2.0 * v
    return matvec


def test_solver_loops_run_at_full_float32(monkeypatch):
    """Inside the loop TF32 is off and matmul precision is "highest",
    whatever the caller set; the caller's settings come back after. The
    float32 products of the preconditioners (the multigrid coarsest
    inverse and alias merge, block-Jacobi's batched inverses) run so even
    when applied outside a loop."""
    from cgx_torch.mats.device import lap2d_operator
    from cgx_torch.solver.multigrid import mg_preconditioner
    from cgx_torch.solver.precond import block_jacobi

    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")  # TF32 on
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        for solve in (cgx_torch.cg_solve, cgx_torch.solve, cgx_torch.pipelined_cg_solve):
            seen = []
            op = types.SimpleNamespace(matvec=_flag_recorder(seen))  # an operator, for solve
            res = solve(op, np.ones(8, np.float32), device="cpu")
            assert bool(res.converged) and seen
            assert all(s == (False, "highest") for s in seen), seen
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "medium"

        seen = []
        matmul = torch.matmul

        def recorded(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return matmul(*args, **kwargs)

        monkeypatch.setattr(torch, "matmul", recorded)
        op = lap2d_operator(16, torch.float32, device="cpu")
        r = torch.ones(256, dtype=torch.float32)
        for pc in (mg_preconditioner(op, galerkin_setup="device").apply,
                   block_jacobi(op, 16, dtype=torch.float32)):
            assert torch.isfinite(pc(r)).all()
        res = cgx_torch.solve(op, r, cgx_torch.SolveConfig(precision="fp32", precond="mg",
                                                           tolerance=1e-4), device="cpu")
        assert bool(res.converged) and len(seen) >= 4  # merge, coarsest, blocks, the loop's
        assert all(s == (False, "highest") for s in seen), seen
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)


def test_new_loops_run_at_full_float32():
    """gvpipe, the Chebyshev iteration, the batched loop and the deflated
    loop also run their mat-vecs with TF32 off, and restore the caller's
    setting."""
    import functools

    from cgx_torch.solver.deflated import DeflationBasis

    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []
        op = types.SimpleNamespace(matvec=_flag_recorder(seen))
        solves = (cgx_torch.gv_cg_solve,
                  functools.partial(cgx_torch.chebyshev_solve, bounds=(1.0, 3.0)))
        for solve in solves:
            seen.clear()
            res = solve(op, np.ones(8, np.float32), device="cpu")
            assert bool(res.converged) and seen
            assert all(s == (False, "highest") for s in seen), seen
        seen.clear()
        res = cgx_torch.cg_solve_batched(_flag_recorder(seen), np.ones((2, 8), np.float32),
                                         device="cpu")
        assert bool(res.converged.all()) and all(s == (False, "highest") for s in seen)
        dia = cgx_torch.as_operator(cgx_torch.lap2d_fd(4), torch.float32, device="cpu")
        basis = DeflationBasis(dia, np.eye(16, 2))
        seen.clear()
        rec = types.SimpleNamespace(matvec=lambda v: (_flag_recorder(seen)(v), dia.matvec(v))[1])
        res = cgx_torch.deflated_cg_solve(rec, np.ones(16, np.float32), basis, tol=1e-4,
                                          device="cpu")
        assert bool(res.converged) and all(s == (False, "highest") for s in seen)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)
