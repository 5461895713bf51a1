"""Run one cell of ``BENCHMARK.json`` once and print its result line.

``python -m cgbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Set-up builds the cell's operator on the card with the program's own
builder and runs one warm-up solve. The window is a closed loop: one
client calls ``cgx_torch.solve`` on a fresh right-hand side (``traffic``)
as soon as the last answer is on the host, and runs whole solves until
``--seconds`` have passed since the first call. With ``--trace 1`` a
``torch.profiler`` window covers the same loop. After the window the
program's state is freed and the judged answers are compared with the
plain reference (``judge``). The last line of standard output is one JSON
object; the numbers compared, beside their limits, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import inspect
import json
import math
import pkgutil
import sys
import time

from cgbench import judge, roofline, spec, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "cgx")  # JAX and the JAX package, by top-level name


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m cgbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(names=None) -> list:
    """The top-level names of ``FORBIDDEN`` among ``names`` (the loaded
    modules by default), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def launch_count() -> int:
    """The sum of the ``.launches`` of every kernel wrapper in
    ``cgx_torch.ops`` (an int, or a dict of ints by layout)."""
    import cgx_torch.ops as ops

    seen, total = set(), 0
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for obj in vars(mod).values():
            n = getattr(obj, "launches", None) if inspect.isfunction(obj) else None
            if n is None or id(obj) in seen:
                continue
            seen.add(id(obj))
            total += sum(n.values()) if isinstance(n, dict) else int(n)
    return total


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _finite(v):
    return v if not isinstance(v, float) or math.isfinite(v) else repr(v)


def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
            started: float, marks: dict = None) -> dict:
    """One run of ``cell``: set-up, window, comparison. Returns the result
    object, ``checks`` last. ``marks``: the set-up's steps so far, each
    name beside the clock at its end."""
    import torch

    import cgx_torch

    cuda = torch.device(device).type == "cuda"
    marks = {**(marks or {}), "import cgx_torch": time.perf_counter()}
    mix = cell.mix
    problem = spec.load_module("problems", cell.config["problem"])
    plain = spec.load_module("reference", cell.config["problem"])
    rhs = traffic.Rhs(mix, plain.source(cell.config, device))
    op = problem.operator(cell.config, rhs.dtype, device)
    _sync(device)
    marks["operator"] = time.perf_counter()

    def solve_config(tol):
        return cgx_torch.SolveConfig(**mix["solve"], tolerance=tol)

    b, tol = rhs.make(traffic.WARMUP)
    int(cgx_torch.solve(op, b, solve_config(tol), device=device).iterations)
    _sync(device)
    marks["warm-up solve"] = time.perf_counter()
    setup_s = marks["warm-up solve"] - started
    last = started
    for name, t in marks.items():  # where set-up went, for the record
        print(f"setup {name} {t - last:.3f} s", file=sys.stderr)
        last = t

    n, ndiag = plain.size(cell.config), len(plain.offsets(cell.config))
    reservoir = judge.Reservoir(seed, int(cell.cell["judged"]), n, rhs.dtype, pin=cuda)
    solves = []
    launches0 = launch_count()
    with contextlib.ExitStack() as stack:
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=activities))
            span = record_function
        else:
            span = lambda name: contextlib.nullcontext()  # noqa: E731
        t0, j = None, 0
        while True:
            with span(trace.RHS):
                b, tol = rhs.make(j)
                cfg = solve_config(tol)
            with span(trace.SOLVE):
                t_call = time.perf_counter()
                res = cgx_torch.solve(op, b, cfg, device=device)
                k, converged = int(res.iterations), bool(res.converged)
                _sync(device)
                t_done = time.perf_counter()
            t0 = t_call if t0 is None else t0
            solves.append({"seconds": t_done - t_call, "k": k, "converged": converged})
            reservoir.offer(j, res.x, k, res.residual_norm)
            j += 1
            if t_done - t0 >= seconds:
                break
    _sync(device)
    launches = launch_count() - launches0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del res, b, op
    if cuda:
        torch.cuda.empty_cache()

    work = dict(cell.cell["work"])
    count = spec.load_module("work", work.pop("method")).count(
        n, ndiag, sum(s["k"] + 1 for s in solves), len(solves), **work)
    summary = trace.reduce(prof) if prof is not None else None
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec = {"setup_s": setup_s, "window_s": t_done - t0, "solves": solves, "launches": launches,
           "peak_bytes": peak, "trace": summary, "work": count,
           "peaks": roofline.card(name) if cuda else None}
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(not s["converged"] for s in solves)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": peak}
    if traced:
        dev.update(busy_s=summary["busy_s"] if summary else 0.0,
                   window_s=summary["window_s"] if summary else 0.0)

    values = judge.compare(cell, rhs, reservoir.kept(), device)
    values["unconverged"] = failed
    table = judge.checks(values, cell.cell["limits"])
    out = {"correct": judge.passed(table), "attempted": len(solves), "failed": failed,
           "metrics": metrics, "device": dev}
    if summary:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in table.items()}
    return out


def finish(out: dict) -> int:
    """Refuse a process that loaded JAX or the JAX package (no result);
    else print the compared numbers as the last lines of standard error,
    then the result as the last line of standard output."""
    leaked = forbidden_modules()
    if leaked:
        print(f"cgbench: the process loaded {', '.join(leaked)}: no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv, started: float = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, FileNotFoundError, ValueError) as e:
        print(f"cgbench: {e}", file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"cgbench: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    marks = {"import torch": time.perf_counter()}
    return finish(measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", started,
                          marks))
