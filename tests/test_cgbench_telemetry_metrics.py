"""The benchmark's readers of the solve records (``cgbench/metrics/``
``prepare_ms``, ``enqueue_us_per_launch``, ``host_reads_per_solve``,
``allocs_per_solve``): on synthetic records, and in one traced run of the
harness on the CPU at a small grid."""

import time

import pytest

from cgbench import run, spec
from cgx_torch.utils import timer

READERS = ("prepare_ms", "enqueue_us_per_launch", "host_reads_per_solve", "allocs_per_solve")


def reader(name):
    return spec.load_module("metrics", name).read


def record(sid, prepare_ns, enqueues_ns, launches, host_reads, allocs):
    spans = [{"name": timer.SOLVE, "solve": sid, "start_ns": 0, "end_ns": 10**9, "parent": None},
             {"name": timer.PREPARE, "solve": sid, "start_ns": 0, "end_ns": prepare_ns,
              "parent": 0},
             {"name": timer.LOOP, "solve": sid, "start_ns": prepare_ns, "end_ns": 10**9,
              "parent": 0}]
    t = prepare_ns
    for ns in enqueues_ns:
        spans.append({"name": timer.ENQUEUE, "solve": sid, "start_ns": t, "end_ns": t + ns,
                      "parent": 2})
        t += ns
    return {"id": sid, "route": "stream", "n": 100, "spans": spans,
            "counters": {"launches": launches, "host_reads": host_reads, "allocs": allocs,
                         "device_mallocs": 0}}


@pytest.fixture
def records(monkeypatch):
    """Three records: an older solve's, then the window's two."""
    kept = [record(1, 9_000_000, [1_000], 1, 99, 999),
            record(2, 2_000_000, [30_000, 10_000], 64, 5, 10),
            record(3, 4_000_000, [20_000], 36, 7, 20)]
    monkeypatch.setattr(timer, "_records", kept)
    return kept


WANT = {"prepare_ms": 3.0,  # (2 + 4) ms over two solves
        "enqueue_us_per_launch": 60.0 / 100,  # 60 us of enqueues over 100 launches
        "host_reads_per_solve": 6.0,
        "allocs_per_solve": 15.0}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_takes_the_windows_records(records, name):
    rec = {"solves": [{"k": 10}, {"k": 10}]}
    assert reader(name)(rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_no_value_with_fewer_records_than_solves(records, name):
    assert reader(name)({"solves": [{"k": 10}] * 4}) is None
    assert reader(name)({"solves": []}) is None


@pytest.mark.parametrize("name", READERS)
def test_no_value_from_a_program_without_records(monkeypatch, name):
    """The parent of this change has no ``solve_records``: no value, no
    error."""
    monkeypatch.delattr(timer, "solve_records")
    assert reader(name)({"solves": [{"k": 10}]}) is None


def test_uncounted_fields_give_no_value(records):
    """A route whose loop keeps no counters, or a solve off CUDA, gives
    no value for the metrics that read them."""
    for r in records:
        r["counters"].update(launches=None, host_reads=None, allocs=None)
    rec = {"solves": [{"k": 1}] * 2}
    assert [reader(n)(rec) for n in READERS[1:]] == [None, None, None]
    assert reader("prepare_ms")(rec) == pytest.approx(3.0)


def test_a_traced_run_reports_the_four(monkeypatch):
    """One traced run of the harness on the CPU at a small grid reports
    all four, each the mean of the window's records. The CPU has no
    caching allocator to read: a stand-in for its counts gives each solve
    three allocations."""
    reads = iter(range(0, 10**6, 3))
    monkeypatch.setattr(timer, "_memory", lambda device: (next(reads), 0))
    timer.clear_solve_records()
    cell = spec.load_cell("p2d1000.fp32_resident")
    cell.config["grid"], cell.config["n"] = 24, 576
    out = run.measure(cell, 2**31 + 11, 0.2, True, "cpu", time.perf_counter())
    assert out["correct"]
    got = {m: out["metrics"][m] for m in READERS}
    assert {m: v["unit"] for m, v in got.items()} == {
        m["name"]: m["unit"] for m in spec.benchmark()["per_layer"] if m["name"] in READERS}
    window = timer.solve_records()[-out["attempted"]:]
    assert len(window) == out["attempted"] and {r["route"] for r in window} == {"resident"}
    assert got["allocs_per_solve"]["value"] == 3.0
    reads = sum(r["counters"]["host_reads"] for r in window) / len(window)
    assert got["host_reads_per_solve"]["value"] == pytest.approx(reads)
    assert got["prepare_ms"]["value"] > 0 and got["enqueue_us_per_launch"]["value"] > 0
    timer.clear_solve_records()
