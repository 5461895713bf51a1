"""Analysis-report CLI (counterpart of ``cgx/bench/report.py``;
reference L7: plots.ipynb as a command).

    python -m cgx_torch.bench.report strong_scaling.txt weak_scaling.txt out_figs/

reads the reference-schema CSVs (ours or the reference's own
``results/*.txt``), prints speedup/efficiency tables with fitted Amdahl
serial fractions, and regenerates the figure set when matplotlib is
present.
"""

from __future__ import annotations

import sys

import numpy as np

from cgx_torch.bench.analysis import (
    ScalingTable,
    amdahl_bound,
    fit_alpha,
    group_ladders,
    make_plots,
    weak_efficiency,
)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(
            "usage: python -m cgx_torch.bench.report <strong.txt> <weak.txt> [out_dir]",
            file=sys.stderr,
        )
        return 1
    strong_path, weak_path = argv[0], argv[1]
    out_dir = argv[2] if len(argv) > 2 else None

    strong = ScalingTable.read(strong_path)
    print("== strong scaling ==")
    for n in sorted(strong.by_n):
        sp = strong.speedup(n)
        alpha = fit_alpha(sp)
        ps = np.array([p for p, _ in sp])
        line = "  ".join(f"p={p}:{s:6.2f}x" for p, s in sp)
        print(f"N={n:6d}  alpha={alpha:.4f}  {line}")
        bound = amdahl_bound(alpha, ps)
        print(
            f"         amdahl-bound  "
            + "  ".join(f"p={p}:{b:6.2f}x" for p, b in zip(ps, bound))
        )

    weak = ScalingTable.read(weak_path)
    print("== weak scaling (N(p) = N0*sqrt(p)) ==")
    ladders = group_ladders(weak.by_n)
    for n0 in sorted(ladders):
        try:
            eff = weak_efficiency(ladders[n0])
        except ValueError:
            continue
        print(
            f"N0={n0:6d}  "
            + "  ".join(f"p={p}:{e:5.1%}" for p, e in eff)
        )

    if out_dir:
        written = make_plots(strong_path, weak_path, out_dir)
        for w in written:
            print("wrote", w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
