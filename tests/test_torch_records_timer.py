"""Solve records, the phase timer and the profiler hook of the port
(cgx_torch.utils.records, .timer) against cgx's (cgx/utils/records.py,
timer.py; tests/test_utils.py:14-45): cgx's cases run on both packages,
and the same fields give byte-equal JSON, CSV rows and [STEP k] lines."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgx
from cgx.utils.records import SolveRecord as CgxRecord
from cgx.utils.timer import PhaseTimer as CgxTimer
import cgx_torch
from cgx_torch.utils.records import SolveRecord
from cgx_torch.utils.timer import PhaseTimer, trace

TIMERS = {"cgx": CgxTimer, "port": PhaseTimer}
RECORDS = {"cgx": CgxRecord, "port": SolveRecord}


def _solve(package: str, n: int):
    """lap2d_reference(n) at tol 1e-8 with a 16-entry history, in one package."""
    if package == "cgx":
        dia = cgx.lap2d_reference(n)
        return cgx.cg_solve(cgx.DiaOperator.from_host(dia), jnp.asarray(cgx.source_term(n)),
                            tol=1e-8, history=16)
    dia = cgx_torch.lap2d_reference(n)
    return cgx_torch.cg_solve(cgx_torch.as_operator(dia, device="cpu"),
                              cgx_torch.source_term(n), tol=1e-8, history=16, device="cpu")


@pytest.mark.parametrize("package", ["cgx", "port"])
def test_phase_timer(package):
    t = TIMERS[package]()
    with t.phase("a"):
        sum(range(1000))
    with t.phase("b"):
        pass
    with t.phase("a"):
        pass
    rep = t.report()
    assert set(rep) == {"a", "b"}
    assert t.counts["a"] == 2
    assert "a" in t.summary()


def test_phase_timer_syncs_on_tensors_and_formats_as_cgx():
    """A phase given tensors waits for their device (a no-op on the CPU)
    and counts as cgx's; the summary has cgx's format for the same totals."""
    t = PhaseTimer()
    x = torch.ones(4)
    with t.phase("solve", x, x * 2, "not a tensor"):
        x = x + 1
    ref = CgxTimer()
    ref.totals, ref.counts = {"solve": 0.25, "setup": 0.75}, {"solve": 1, "setup": 2}
    t.totals, t.counts = dict(ref.totals), dict(ref.counts)
    assert t.summary() == ref.summary() and t.report() == ref.report()


@pytest.mark.parametrize("package", ["cgx", "port"])
def test_solve_record_roundtrip(tmp_path, package):
    n = 128
    res = _solve(package, n)
    rec = RECORDS[package].from_result(res, n=n, elapsed_s=0.5, psize=4)
    assert rec.iterations == int(res.iterations)
    assert rec.converged
    j = rec.to_json()
    assert '"psize": 4' in j
    mpi_csv = tmp_path / "strong.txt"
    rec.append_mpi_row(mpi_csv)
    assert mpi_csv.read_text().strip() == f"{n},4,0.5"
    cuda_csv = tmp_path / "cuda.txt"
    rec.append_cuda_row(cuda_csv, 1024, 16)
    assert cuda_csv.read_text().strip() == "1024,16,0.5"
    assert "[STEP" in rec.debug_line()


def test_from_result_matches_cgx():
    """The port's record of its result has cgx's record of cgx's result:
    the same k and flags, and the finite history within fp64 rounding."""
    ours = SolveRecord.from_result(_solve("port", 128), n=128, elapsed_s=0.5)
    theirs = CgxRecord.from_result(_solve("cgx", 128), n=128, elapsed_s=0.5)
    assert (ours.iterations, ours.converged, ours.breakdown) == (
        theirs.iterations, theirs.converged, theirs.breakdown)
    assert len(ours.history) == len(theirs.history) == 16
    np.testing.assert_allclose(ours.history, theirs.history, rtol=1e-12)
    assert ours.residual_norm == pytest.approx(theirs.residual_norm, rel=1e-6)


def test_from_result_drops_nan_history_and_reads_tensors():
    res = cgx_torch.CGResult(
        x=torch.zeros(3), iterations=torch.tensor(2, dtype=torch.int32),
        converged=torch.tensor(True), residual_norm=torch.tensor(1e-9, dtype=torch.float64),
        rsold=torch.tensor(1.0), history=torch.tensor([3.0, 2.0, float("nan")],
                                                      dtype=torch.bfloat16),
        breakdown=torch.tensor(False))
    rec = SolveRecord.from_result(res, n=3, elapsed_s=0.1)
    assert rec.history == [3.0, 2.0] and rec.iterations == 2 and rec.converged is True
    empty = res._replace(history=torch.full((2,), float("nan")))
    assert SolveRecord.from_result(empty, n=3, elapsed_s=0.1).history is None


FIELDS = [
    dict(n=10000, iterations=488, converged=True, residual_norm=9.6e-11,
         true_relative_residual=3.25e-12, elapsed_s=0.12345678901234, psize=1,
         method="reference", strategy="single", fmt="dense", precision="fp64",
         breakdown=False, flops_per_iter=2e8, bytes_per_iter=8e8,
         phase_times={"setup": 0.5, "solve": 1.25}, history=[1.0, 0.5, 0.25]),
    dict(n=1024, iterations=7, converged=False, residual_norm=float("inf"),
         elapsed_s=3.0, psize=4, breakdown=True),
]


@pytest.mark.parametrize("fields", FIELDS, ids=["full", "defaults"])
def test_writers_byte_equal_cgx(tmp_path, fields):
    ours, theirs = SolveRecord(**fields), CgxRecord(**fields)
    assert ours.to_json() == theirs.to_json()
    assert json.loads(ours.to_json())["n"] == fields["n"]
    assert ours.debug_line() == theirs.debug_line()
    for rec, tag in ((ours, "port"), (theirs, "cgx")):
        rec.append_mpi_row(tmp_path / f"mpi_{tag}.txt")
        rec.append_cuda_row(tmp_path / f"cuda_{tag}.txt", 1024, 16)
    for kind in ("mpi", "cuda"):
        assert (tmp_path / f"{kind}_port.txt").read_bytes() == \
            (tmp_path / f"{kind}_cgx.txt").read_bytes()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        y = torch.ones(64) @ torch.ones(64)
    assert float(y) == 64.0
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with trace(None):  # a no-op
        pass
    assert not (tmp_path / "None").exists()


def test_exports_match_cgx_utils():
    import cgx.utils as cgx_utils

    import cgx_torch.utils as port_utils

    names = {n for n in dir(cgx_utils) if not n.startswith("_")} - {
        "checkpoint", "collectives", "records", "timer"}
    assert names <= set(dir(port_utils))
    for name in ("CGCheckpoint", "cg_solve_resumable", "sharded_cg_solve_resumable",
                 "SolveRecord", "PhaseTimer", "trace", "GridDiaOperator"):
        assert hasattr(cgx_torch, name), name
