"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process (the benchmark's own runs do not run it):

    python3 -m cgbench.calibrate --workload <cell> --solves <n> [--seeds 12] [--controls 3] [--first <seed>]

Each seed judges the solves that a run of ``--solves`` solves judges (the
reservoir's draws from that seed, ``judge.judged``), each solved through
the program exactly as the window calls it and compared with the float64
reference; the seed's reading of each number is its largest, as in a run.
Besides the numbers a run compares, ``residual`` is the true residual
``||b - A x|| / ||b||``, in float64 on the reference's bands. For the first ``--controls`` seeds the same right-hand sides also go, in
the program's place, through the two controls:

- ``program_bf16``: the program's own lower-precision path, the mix with
  ``precision="bf16"`` on its bfloat16 operator;
- ``reference_bf16``: the plain reference with bfloat16 vectors
  (``reference/cg.py``);

and through one fault that a faster, less accurate program would have:

- ``stops_early``: the program at ten times the mix's tolerance.

A control is capped at twice the program's iterations plus 64. Prints one
JSON line a seed and kind, then a summary: the lower reading (the largest
over the program's seeds) and the upper ones (the smallest over the
controls', and over the fault's) of each number.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from cgbench import judge, spec, traffic
from cgbench.reference import cg as ref_cg

NUMBERS = ("x_gap", "k_gap", "residual_over_tol", "residual", "unconverged")
CONTROLS = ("program_bf16", "reference_bf16")
FAULTS = ("stops_early",)
EARLY = 10.0  # ``stops_early``'s tolerance, over the mix's


class Calibration:
    def __init__(self, cell: spec.Cell, device="cuda"):
        import cgx_torch

        self.solve, self.config = cgx_torch.solve, cgx_torch.SolveConfig
        self.cell, self.device = cell, device
        problem = spec.load_module("problems", cell.config["problem"])
        plain = spec.load_module("reference", cell.config["problem"])
        self.rhs = traffic.Rhs(cell.mix, plain.source(cell.config, device))
        self.op = problem.operator(cell.config, self.rhs.dtype, device)
        self.op16 = problem.operator(cell.config, torch.bfloat16, device)
        self.bands64 = plain.bands(cell.config, torch.float64, device)
        self.offsets, self.n = plain.offsets(cell.config), plain.size(cell.config)
        self.precond = cell.mix["solve"].get("precond")
        self.cache = {}

    def _program(self, b, tol, **over):
        t0 = time.perf_counter()
        mix = {**self.cell.mix["solve"], **over.pop("solve", {})}
        res = self.solve(over.pop("op", self.op), b, self.config(**mix, tolerance=tol, **over),
                         device=self.device)
        return (res.x, int(res.iterations), float(res.residual_norm), bool(res.converged),
                time.perf_counter() - t0)

    def entry(self, j: int, controls: bool) -> dict:
        """``{kind: {number: value, "k", "k_ref", "seconds"}}`` for solve
        ``j``, each kind of each solve run once."""
        have = self.cache.get(j, {})
        if "program" in have and (not controls or "reference_bf16" in have):
            return have
        b, tol = self.rhs.make(j)
        ref = ref_cg.cg(self.bands64, self.offsets, b.to(torch.float64), tol, self.n,
                        precond=self.precond)
        runs = {"program": self._program(b, tol)}
        if controls:
            cap = 2 * runs["program"][1] + 64
            runs["program_bf16"] = self._program(b.to(torch.bfloat16), tol, op=self.op16,
                                                 solve={"precision": "bf16"}, maxiter=cap)
            t0 = time.perf_counter()
            c = ref_cg.cg(self.bands64, self.offsets, b.to(torch.bfloat16), tol, cap,
                          precond=self.precond)
            runs["reference_bf16"] = (c.x, c.k, c.residual, c.converged, time.perf_counter() - t0)
            runs["stops_early"] = self._program(b, EARLY * tol)
        for kind, (x, k, res, conv, secs) in runs.items():
            have[kind] = {"x_gap": judge.gap(x, ref.x), "k_gap": abs(k - ref.k) / max(ref.k, 1),
                          "residual_over_tol": res / tol if res == res else math.inf,
                          "residual": ref_cg.true_residual(self.bands64, self.offsets, x, b),
                          "unconverged": int(not conv), "k": k, "k_ref": ref.k,
                          "seconds": secs}
        self.cache[j] = have
        return have


def readings(cell: spec.Cell, seeds: list, controls: int, solves: int, device="cuda") -> list:
    cal = Calibration(cell, device)
    out = []
    for i, seed in enumerate(seeds):
        js = judge.judged(seed, int(cell.cell["judged"]), solves)
        entries = [cal.entry(j, i < controls) for j in js]
        for kind in ("program",) + ((CONTROLS + FAULTS) if i < controls else ()):
            rows = [e[kind] for e in entries]
            line = {"cell": cell.name, "seed": seed, "kind": kind, "judged": js,
                    **{m: max(r[m] for r in rows) for m in NUMBERS},
                    **{f: [r[f] for r in rows] for f in ("k", "k_ref", "seconds")}}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def summary(lines: list) -> dict:
    def least(kinds):
        got = [ln for ln in lines if ln["kind"] in kinds]
        return {m: min(ln[m] for ln in got) for m in NUMBERS} if got else None

    return {"lower": {m: max(ln[m] for ln in lines if ln["kind"] == "program") for m in NUMBERS},
            "upper": least(CONTROLS),
            "upper_by_kind": {kind: least((kind,)) for kind in CONTROLS + FAULTS},
            "seeds": len({ln["seed"] for ln in lines if ln["kind"] == "program"}),
            "control_seeds": len({ln["seed"] for ln in lines if ln["kind"] in CONTROLS})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cgbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--solves", type=int, required=True, help="solves in a run's window")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("cgbench.calibrate: no CUDA device")
        return 2
    lines = readings(cell, [args.first + 7919 * i for i in range(args.seeds)], args.controls,
                     args.solves)
    print(json.dumps({"cell": cell.name, "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
