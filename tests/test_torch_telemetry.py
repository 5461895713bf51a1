"""The spans and counters of ``cgx_torch.solve`` (``cgx_torch.utils.timer``):
the span tree of each route whose host loop carries spans, the profiler's
own events, the counters against the wrappers' launch counts, nothing
kept without a profiler, and the records file of ``trace``.

This file imports no JAX, so its CUDA case runs on a machine without it:
``python -m pytest tests/test_torch_telemetry.py --noconftest -m cuda``.
"""

import collections
import glob
import json
import os
import warnings

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import cgx_torch
from cgx_torch import config
from cgx_torch.mats.generators import lap2d_fd, source_term
from cgx_torch.ops import cg_kernel, cg_stream, dia_spmv
from cgx_torch.utils import timer

GRID = 24
# route: (precond, resident); a resident budget of 0 sends the solve to the streaming loop
ROUTES = {"resident": (None, True), "resident_neumann": ("neumann", True),
          "stream": (None, False), "stream_pcg": ("neumann", False)}
# the wrapper each route's enqueue spans launch
SITES = {"resident": cg_kernel.dia_cg_chunk, "resident_neumann": cg_kernel.dia_cg_chunk,
         "stream": cg_stream._stream_iteration, "stream_pcg": cg_stream._stream_iteration_pcg}
# reads in prepare: the streaming route's torch.equal of the bf16 bands and pow2_rhs_scale's pair
PREPARE_READS = {"resident": 0, "resident_neumann": 0, "stream": 3, "stream_pcg": 0}
SPAN_NAMES = (timer.SOLVE, timer.PREPARE, timer.LOOP, timer.ENQUEUE, timer.READ)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_records():
    timer.clear_solve_records()
    yield
    timer.clear_solve_records()


def problem(device="cpu", grid=GRID):
    dia = lap2d_fd(grid)
    op = cgx_torch.as_operator(dia, torch.float32, device=device)
    b = torch.as_tensor(source_term(dia.shape[0]), dtype=torch.float32, device=device)
    return op, b


def run(monkeypatch, route, device="cpu", grid=GRID, traced=True):
    """One solve on ``route``; returns (result, the profiler or None)."""
    precond, resident = ROUTES[route]
    if not resident:
        monkeypatch.setattr(config, "RESIDENT_BUDGET_BYTES", 0)
    op, b = problem(device, grid)
    cfg = cgx_torch.SolveConfig(precision="fp32", use_pallas=True, precond=precond,
                                tolerance=1e-5 * float(torch.linalg.vector_norm(b)))
    if not traced:
        return cgx_torch.solve(op, b, cfg, device=device), None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=activities) as prof:
        res = cgx_torch.solve(op, b, cfg, device=device)
    return res, prof


def launches(site) -> int:
    n = site.launches
    return sum(n.values()) if isinstance(n, dict) else n


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_span_tree(monkeypatch, route):
    """The solve span holds prepare and the loop; the first read sits in
    prepare, each chunk's enqueue and read in the loop; every span nests
    in its parent's time and carries the solve's id."""
    res, _ = run(monkeypatch, route)
    (rec,) = timer.solve_records()
    spans = rec["spans"]
    assert rec["route"] == route.removesuffix("_neumann")
    assert rec["n"] == GRID * GRID
    assert {s["solve"] for s in spans} == {rec["id"]}
    assert spans[0]["name"] == timer.SOLVE and spans[0]["parent"] is None
    names = [s["name"] for s in spans]
    parents = [spans[s["parent"]]["name"] if s["parent"] is not None else None for s in spans]
    assert list(zip(names, parents))[:4] == [
        (timer.SOLVE, None), (timer.PREPARE, timer.SOLVE), (timer.READ, timer.PREPARE),
        (timer.LOOP, timer.SOLVE)]
    loop = [(n, p) for n, p in zip(names[4:], parents[4:])]
    chunks = len(loop) // 2
    assert chunks >= 1 and loop == [(timer.ENQUEUE, timer.LOOP), (timer.READ, timer.LOOP)] * chunks
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    # prepare ends where the loop begins
    assert spans[1]["end_ns"] <= spans[3]["start_ns"]
    assert bool(res.converged)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_spans_are_the_profilers_events(monkeypatch, route):
    """Each span is an event of the profiler's own trace, as many of each
    name as the record holds, all inside the solve's event."""
    _, prof = run(monkeypatch, route)
    (rec,) = timer.solve_records()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() in SPAN_NAMES]
    assert collections.Counter(n for n, _, _ in events) == collections.Counter(
        s["name"] for s in rec["spans"])
    ((_, t0, t1),) = [e for e in events if e[0] == timer.SOLVE]
    assert all(t0 <= s and e <= t1 for _, s, e in events)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_counters(monkeypatch, route):
    """host_reads: the read spans and prepare's listed reads; launches:
    the change of the enqueued wrapper's .launches (the Neumann resident
    route's B1 set-up launch, in prepare, is not an enqueue's)."""
    site = SITES[route]
    before, before_all = launches(site), launches(dia_spmv.dia_matvec)
    res, _ = run(monkeypatch, route)
    (rec,) = timer.solve_records()
    counters = rec["counters"]
    reads = sum(s["name"] == timer.READ for s in rec["spans"])
    assert counters["host_reads"] == reads + PREPARE_READS[route]
    assert counters["launches"] == launches(site) - before > 0
    assert launches(dia_spmv.dia_matvec) - before_all == (route == "resident_neumann")
    k = int(res.iterations)
    chunk = 64 if route.startswith("resident") else 32
    assert reads == 1 + -(-k // chunk)
    assert counters["allocs"] is None and counters["device_mallocs"] is None  # no card


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_nothing_is_kept_without_a_profiler(monkeypatch, route):
    """Without a profiler no record is kept, and the answer is bitwise the
    recorded solve's."""
    plain, _ = run(monkeypatch, route, traced=False)
    assert timer.solve_records() == []
    traced, _ = run(monkeypatch, route)
    assert len(timer.solve_records()) == 1
    assert torch.equal(plain.x, traced.x)
    assert int(plain.iterations) == int(traced.iterations)


def test_another_route_keeps_its_name_and_the_solve_span():
    """A route whose loop carries no spans: the solve span, prepare up to
    the hand-over, the route's name; no loop counters."""
    op, b = problem()
    with profile(activities=[ProfilerActivity.CPU]):
        cgx_torch.solve(op, b, cgx_torch.SolveConfig(precision="fp32", tolerance=1e-3),
                        device="cpu")
        cgx_torch.solve(op, b, cgx_torch.SolveConfig(precision="fp32", method="pipelined",
                                                     tolerance=1e-3), device="cpu")
    records = timer.solve_records()
    assert [r["route"] for r in records] == ["reference", "pipelined"]
    assert records[0]["id"] < records[1]["id"]
    for rec in records:
        assert [s["name"] for s in rec["spans"]] == [timer.SOLVE, timer.PREPARE]
        assert rec["counters"]["launches"] is None and rec["counters"]["host_reads"] is None


def test_trace_writes_the_windows_records(tmp_path, monkeypatch):
    """``trace(log_dir)`` writes the records of the solves made inside it
    beside its Chrome trace; the solves before it are left out."""
    op, b = problem()
    cfg = cgx_torch.SolveConfig(precision="fp32", use_pallas=True, tolerance=1e-3)
    with profile(activities=[ProfilerActivity.CPU]):
        cgx_torch.solve(op, b, cfg, device="cpu")
    with cgx_torch.trace(str(tmp_path)):
        cgx_torch.solve(op, b, cfg, device="cpu")
        cgx_torch.solve(op, b, cfg, device="cpu")
    (chrome,) = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    (path,) = glob.glob(os.path.join(tmp_path, "solves_*.json"))
    with open(path) as f:
        written = json.load(f)
    assert written["trace"] == os.path.basename(chrome)
    assert written["solves"] == timer.solve_records()[1:]
    assert len(written["solves"]) == 2
    with open(chrome) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(SPAN_NAMES) <= names


def test_the_records_are_bounded():
    """The buffer keeps the last KEPT solves, oldest first."""
    assert timer._records.maxlen == timer.KEPT == 4096
    op, b = problem(grid=8)
    cfg = cgx_torch.SolveConfig(precision="fp32", use_pallas=True, tolerance=1e-3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            cgx_torch.solve(op, b, cfg, device="cpu")
    ids = [r["id"] for r in timer.solve_records()]
    assert len(ids) == 3 and ids == sorted(ids)
    timer.clear_solve_records()
    assert timer.solve_records() == []


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident", "stream", "stream_pcg"])
def test_host_reads_are_the_syncs_on_the_card(monkeypatch, cuda, route):
    """On the card, ``host_reads`` is the number of synchronising calls
    PyTorch's sync debug mode warns of inside the solve, less one a read
    of the streaming loop: its ``scal[[STOP, K]]`` first copies the index
    list to the card, a blocking host-to-device copy. The allocation
    counters are read there."""
    precond, resident = ROUTES[route]
    if not resident:
        monkeypatch.setattr(config, "RESIDENT_BUDGET_BYTES", 0)
    op, b = problem(cuda, 64)
    cfg = cgx_torch.SolveConfig(precision="fp32", use_pallas=True, precond=precond,
                                tolerance=1e-5 * float(torch.linalg.vector_norm(b)))
    cgx_torch.solve(op, b, cfg, device=cuda)  # builds and warms the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                cgx_torch.solve(op, b, cfg, device=cuda)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    (rec,) = timer.solve_records()
    assert rec["route"] == route
    reads = sum(s["name"] == timer.READ for s in rec["spans"])
    index_copies = reads if route.startswith("stream") else 0
    assert rec["counters"]["host_reads"] + index_copies == len(syncs), syncs
    assert rec["counters"]["allocs"] > 0 and rec["counters"]["device_mallocs"] >= 0
