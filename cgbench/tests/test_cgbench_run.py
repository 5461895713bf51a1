"""Runs of the harness on the CPU at a small grid (the look for a chip
skipped): the result line's schema, the comparison failing under each
fault a solve cell can have and under each control, and the isolation
from JAX and the JAX package. The control at a cell's own size runs on
the card (``cuda``)."""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

import cgx_torch
from cgbench import calibrate, run, spec
from cgbench.reference import cg as ref_cg

REPO = spec.HERE.parent
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 11  # past 32 signed bits, as the driver's seeds are
GRID = 24
# a control's error grows with the grid (bfloat16's x_gap 0.01 at lap2d_fd(32), 0.03 at
# 128, 0.8 at the cells' 3200): at 128 it is past every cell's limit, as at the cells' sizes
CONTROL_GRID = 128


def small(name: str, grid: int = GRID) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config["grid"] = grid
    cell.config["n"] = grid * grid
    return cell


def cpu_run(name: str, traced: bool = False, seconds: float = 0.2, grid: int = GRID) -> dict:
    return run.measure(small(name, grid), SEED, seconds, traced, "cpu", time.perf_counter())


def patch_solve(monkeypatch, change):
    """Break the timed path underneath: every solve's result goes through
    ``change(result) -> result``."""
    solve = cgx_torch.solve
    monkeypatch.setattr(cgx_torch, "solve", lambda *a, **kw: change(solve(*a, **kw)))


def result(x, k, residual, converged=True):
    return types.SimpleNamespace(x=x, iterations=torch.tensor(k, dtype=torch.int32),
                                 residual_norm=torch.as_tensor(residual),
                                 converged=torch.tensor(converged))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = cpu_run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(traced, capsys):
    name = "p2d1000.fp32_resident"
    assert run.finish(cpu_run(name, traced)) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool)
    cell = spec.load_cell(name)
    wanted = {m["name"]: m["unit"] for m in (cell.per_layer if traced else cell.end_to_end)}
    for metric, entry in line["metrics"].items():
        assert set(entry) == {"value", "unit"} and entry["unit"] == wanted[metric]
        assert math.isfinite(entry["value"])
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:  # the CPU has no device trace: its metrics are left out, the host's stay
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["metrics"]) == {"launches_per_iter", "us_per_iter", "iters_per_solve"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(wanted) - {"peak_mem_gib"}  # no card, no peak
    err = captured.err.strip().splitlines()[-len(line["checks"]):]
    assert [ln.split()[:2] for ln in err] == [["check", c] for c in line["checks"]]
    for ln, c in zip(err, line["checks"].values()):
        assert ln.split()[2:] == [str(c["value"]), "limit", str(c["limit"])]


FAULTS = {
    # a step that returns its state unchanged: x stays the start state, 0
    "state_unchanged": lambda r: result(torch.zeros_like(r.x), int(r.iterations),
                                        r.residual_norm),
    # half of the answer left out
    "half_left_out": lambda r: result(torch.cat([r.x[: len(r.x) // 2],
                                                 torch.zeros_like(r.x[len(r.x) // 2:])]),
                                      int(r.iterations), r.residual_norm),
    # the answer altered where it is produced
    "x_altered": lambda r: result(r.x * 1.05, int(r.iterations), r.residual_norm),
    "k_altered": lambda r: result(r.x, 2 * int(r.iterations) + 1, r.residual_norm),
    "not_converged": lambda r: result(r.x, int(r.iterations), r.residual_norm, converged=False),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_fails_the_comparison(monkeypatch, name, fault):
    patch_solve(monkeypatch, FAULTS[fault])
    out = cpu_run(name)
    assert not out["correct"], (fault, out["checks"])


def reference_bf16(op, b, cfg, device):
    """The control: the plain reference with bfloat16 vectors in the
    program's place."""
    sol = ref_cg.cg(op.bands.to(torch.bfloat16), op.offsets, b.to(torch.bfloat16),
                    cfg.tolerance, 4 * b.shape[0], precond=cfg.precond)
    return result(sol.x.to(b.dtype), sol.k, sol.residual, sol.converged)


def program_bf16(op, b, cfg, device, _solve=cgx_torch.solve):
    """The control: the program's own bfloat16 path."""
    op16 = type(op)(op.bands.to(torch.bfloat16), op.offsets)
    cfg16 = cgx_torch.SolveConfig(**{**cell_solve(cfg), "precision": "bf16"},
                                  tolerance=cfg.tolerance, maxiter=4 * b.shape[0])
    r = _solve(op16, b.to(torch.bfloat16), cfg16, device=device)
    return result(r.x.to(b.dtype), int(r.iterations), r.residual_norm, bool(r.converged))


def cell_solve(cfg) -> dict:
    return {"precision": cfg.precision, "use_pallas": cfg.use_pallas, "precond": cfg.precond}


@pytest.mark.parametrize("control", [reference_bf16, program_bf16])
@pytest.mark.parametrize("name", CELLS)
def test_each_control_fails_the_comparison(monkeypatch, name, control):
    monkeypatch.setattr(cgx_torch, "solve", control)
    out = cpu_run(name, grid=CONTROL_GRID)
    assert not out["correct"], out["checks"]


def stop_early(monkeypatch):
    """A faster, less accurate program: every solve stops at ten times the
    tolerance it is given."""
    solve = cgx_torch.solve

    def early(op, b, cfg, **kw):
        cfg = dataclasses.replace(cfg, tolerance=calibrate.EARLY * cfg.tolerance)
        return solve(op, b, cfg, **kw)

    monkeypatch.setattr(cgx_torch, "solve", early)


@pytest.mark.parametrize("name", CELLS)
def test_stopping_early_fails_the_comparison(monkeypatch, name):
    stop_early(monkeypatch)
    out = cpu_run(name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["residual_over_tol"]["value"] > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_controls_fail_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls and the fault at the cell's own size")
    cell = spec.load_cell(name)
    lines = calibrate.readings(cell, [SEED + i for i in range(3)], controls=3,
                               solves=int(cell.cell["judged"]))
    limits = cell.cell["limits"]
    for ln in lines:
        fails = any(not (ln[m] <= limits[m]) for m in limits)
        assert fails == (ln["kind"] != "program"), ln


def test_no_module_of_jax_or_the_jax_package_after_a_run():
    code = ("import time, json; from cgbench import run, spec\n"
            "cell = spec.load_cell('p2d1000.fp32_resident'); cell.config['grid'] = 16\n"
            "run.measure(cell, 5, 0.1, False, 'cpu', time.perf_counter())\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_process_that_loaded_jax_gets_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.finish({"checks": {}}) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err


def test_top_level_names_are_compared_whole():
    assert run.forbidden_modules(["cgx.ops.cg", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "cgx", "flax", "jax", "jaxlib"]
    assert run.forbidden_modules(["cgx_torch", "cgx_torch.ops", "cgxx", "jaxtyping", "numpy",
                                  "cgbench.run"]) == []


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "cgbench", "--workload",
                           "p2d1000.fp32_resident", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "cgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
