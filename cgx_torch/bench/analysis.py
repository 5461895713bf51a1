"""Benchmark analysis (counterpart of ``cgx/bench/analysis.py``, whose
host code this copies: the port imports nothing of cgx; reference L7:
plots.ipynb).

Parses the CSV schemas of the sweep harness / reference ``results/``
files and computes the derived quantities the reference notebook plots:
speedup, parallel efficiency, Amdahl and Gustafson bounds (plots.ipynb
cell 2: ``ALPHAS``, ``show_hard_MPI_results``, ``show_weak_MPI_results``,
``show_CUDA_results``). Plotting is optional (matplotlib if present);
the numeric pipeline is fully testable headless.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Measured Amdahl serial fractions per N from the reference report
# (report.pdf appendix table; plots.ipynb ALPHAS dict).
REFERENCE_ALPHAS: Dict[int, float] = {
    1024: 1 - 0.9753,
    1448: 1 - 0.9852,
    2048: 1 - 0.9910,
    2896: 1 - 0.9935,
    4096: 1 - 0.9950,
    5792: 1 - 0.9966,
    8192: 1 - 0.9981,
    11585: 1 - 0.9988,
    16384: 1 - 0.9996,
}


@dataclasses.dataclass
class ScalingTable:
    """Rows of an ``N,psize,seconds`` CSV grouped by N."""

    by_n: Dict[int, List[Tuple[int, float]]]

    @classmethod
    def parse(cls, rows: Sequence[str]) -> "ScalingTable":
        by_n: Dict[int, List[Tuple[int, float]]] = {}
        for row in rows:
            row = row.strip()
            if not row or row.startswith("#"):
                continue  # '#' header/caveat comments (an extension;
                #           the reference CSVs are comment-free)
            n_s, p_s, t_s = row.split(",")
            by_n.setdefault(int(n_s), []).append((int(p_s), float(t_s)))
        for v in by_n.values():
            v.sort()
        return cls(by_n)

    @classmethod
    def read(cls, path) -> "ScalingTable":
        with open(path) as f:
            return cls.parse(f.readlines())

    def speedup(self, n: int) -> List[Tuple[int, float]]:
        """S(p) = T(1)/T(p) (the hard-scaling plot's y-axis)."""
        rows = self.by_n[n]
        t1 = dict(rows).get(1)
        if t1 is None:
            raise ValueError(f"no p=1 row for N={n}")
        return [(p, t1 / t) for p, t in rows]

    def efficiency(self, n: int) -> List[Tuple[int, float]]:
        """E(p) = S(p)/p (strong) — the weak plot uses weak_efficiency."""
        return [(p, s / p) for p, s in self.speedup(n)]


def amdahl_bound(alpha: float, p: np.ndarray) -> np.ndarray:
    """S(p) <= p / (alpha*p + (1-alpha)) (report MPI-hard slide)."""
    p = np.asarray(p, dtype=float)
    return p / (alpha * p + (1.0 - alpha))


def gustafson_bound(beta: float, p: np.ndarray) -> np.ndarray:
    """Weak-scaling efficiency bound ((1-beta)*p + beta)/p
    (report MPI-weak slide; beta = serial fraction)."""
    p = np.asarray(p, dtype=float)
    return ((1.0 - beta) * p + beta) / p


def group_ladders(
    by_n: Dict[int, List[Tuple[int, float]]],
) -> Dict[int, List[Tuple[int, float]]]:
    """Group weak-scaling rows into ladders keyed by the base size N0,
    reconstructing N0 = round(N / sqrt(p)) from each (N, p) row (the
    inverse of the reference's N(p) = N0*sqrt(p) schedule)."""
    ladders: Dict[int, List[Tuple[int, float]]] = {}
    for n, rows in by_n.items():
        for p, t in rows:
            n0 = int(round(n / np.sqrt(p)))
            ladders.setdefault(n0, []).append((p, t))
    return ladders


def weak_efficiency(ladder: Sequence[Tuple[int, float]]) -> List[Tuple[int, float]]:
    """E_w(p) = T(1)/T(p) for a weak-scaling ladder (constant work per
    device by construction N(p)=N0*sqrt(p))."""
    ladder = sorted(ladder)
    t1 = dict(ladder).get(1)
    if t1 is None:
        raise ValueError("no p=1 rung")
    return [(p, t1 / t) for p, t in ladder]


def fit_alpha(speedups: Sequence[Tuple[int, float]]) -> float:
    """Least-squares fit of the Amdahl serial fraction to measured
    speedups (how the reference derived its ALPHAS table)."""
    ps = np.array([p for p, _ in speedups if p > 1], dtype=float)
    ss = np.array([s for p, s in speedups if p > 1], dtype=float)
    if len(ps) == 0:
        return 0.0
    # S = p / (alpha p + 1 - alpha)  =>  alpha = (p/S - 1) / (p - 1)
    alphas = (ps / ss - 1.0) / (ps - 1.0)
    return float(np.clip(alphas.mean(), 0.0, 1.0))


def make_plots(strong_path, weak_path, out_dir) -> List[str]:
    """Regenerate the reference's figure set from CSVs (MPI_hard.png,
    MPI_weak.png analogues). Returns written paths; no-op without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return []
    import os

    os.makedirs(out_dir, exist_ok=True)
    written = []

    strong = ScalingTable.read(strong_path)
    fig, ax = plt.subplots(figsize=(6, 4))
    for n in sorted(strong.by_n):
        sp = strong.speedup(n)
        ps = [p for p, _ in sp]
        ax.plot(ps, [s for _, s in sp], "o-", label=f"N={n}")
        alpha = REFERENCE_ALPHAS.get(n, fit_alpha(sp))
        grid = np.array(sorted(set(ps)))
        ax.plot(grid, amdahl_bound(alpha, grid), "--", alpha=0.4)
    ax.set_xlabel("devices p")
    ax.set_ylabel("speedup")
    ax.legend()
    ax.set_title("Strong scaling (dashed: Amdahl bound)")
    path = os.path.join(out_dir, "strong_scaling.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    weak = ScalingTable.read(weak_path)
    fig, ax = plt.subplots(figsize=(6, 4))
    ladders = group_ladders(weak.by_n)
    for n0 in sorted(ladders):
        try:
            eff = weak_efficiency(ladders[n0])
        except ValueError:
            continue
        ax.plot([p for p, _ in eff], [e for _, e in eff], "o-", label=f"N0={n0}")
    ax.set_xlabel("devices p")
    ax.set_ylabel("weak efficiency")
    ax.legend()
    ax.set_title("Weak scaling, N(p)=N0*sqrt(p), fixed iterations")
    path = os.path.join(out_dir, "weak_scaling.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(path)
    return written


# --- analytic communication-cost model ---------------------------------
#
# The reference's report models each collective as
#     T = alpha * log2(p) + beta * (p - 1) / p * m
# (latency alpha per hop of a log-tree, inverse bandwidth beta per
# byte, message m bytes — Thakur, Rabenseifner & Gropp's MPICH model,
# cited on the MPI-hard slide). With the per-iteration collective
# signature pinned by tests/test_torch_collective_counts.py, a whole solve
# costs
#     T(p) = k * [ t1 / p  +  n_lat * alpha * log2(p)
#                  + n_msgs * alpha
#                  + beta * (p - 1) / p * B_bw  +  beta * B_nbr ]
# where t1 is the serial per-iteration compute time, n_lat the number
# of TREE collectives per iteration (psum/all-gather: alpha * log2 p
# each), n_msgs the number of single-hop neighbour messages (each one
# alpha — a depth-d ppermute is one link traversal, not a log tree),
# B_bw the bytes of p-scaling (all-gather/reduce-scatter) traffic, and
# B_nbr the fixed neighbour-exchange (halo) bytes. This is the only
# honest multi-chip story a one-chip rig can tell: fit (t1, alpha,
# beta) from measured rows, predict the reference's own cluster curve,
# and predict where the sharded strategies cross over on a mesh of cards.


@dataclasses.dataclass
class CommModel:
    """Per-iteration cost model for one comm strategy.

    n_lat: TREE collective launches per iteration (each alpha * log2
      p). Reference CG = 3 (2 scalar psums + the gather's own latency
      term); pipelined = 1; chebyshev ~ 1/check_every.
    n_msgs: single-hop neighbour ppermute launches per iteration
      (each one alpha, independent of p; halo strategies pay 2 per
      mat-vec). Counted uniformly across models so crossover charts
      compare like with like.
    bw_elems(n): elements of (p-1)/p-scaling traffic per iteration
      (the all-gather of p in the reference pattern = n).
    nbr_elems(n): fixed per-iteration neighbour-exchange elements
      (halo strategy: 2 * bandwidth, independent of p).
    """

    name: str
    n_lat: float
    bw_elems: "object" = staticmethod(lambda n: 0.0)
    nbr_elems: "object" = staticmethod(lambda n: 0.0)
    bytes_per_elem: int = 8
    n_msgs: float = 0.0
    # tree-latency overlap fraction: the portion of the n_lat term that
    # rides concurrently with the local compute (communication-hiding
    # recurrences; method='gvpipe' = 1.0). The hidden portion only
    # costs when it exceeds the compute it hides behind.
    overlap: float = 0.0
    # multiplicative serial-compute overhead (e.g. gvpipe's extra
    # recurrence axpys + amortized guarded replacement mat-vecs).
    compute_factor: float = 1.0

    def iter_time(
        self, p, n: int, *, t1: float, alpha: float, beta: float
    ):
        """Seconds per iteration at p shards (t1 = serial seconds per
        iteration; alpha seconds; beta seconds/byte)."""
        p = np.asarray(p, np.float64)
        lat_tree = alpha * self.n_lat * np.log2(np.maximum(p, 1.0))
        comp = self.compute_factor * t1 / p
        if self.overlap > 0.0:
            hidden = self.overlap * lat_tree
            exposed = lat_tree - hidden + np.maximum(hidden - comp, 0.0)
        else:
            exposed = lat_tree
        lat = exposed + alpha * self.n_msgs * (p > 1)
        bw = beta * self.bytes_per_elem * self.bw_elems(n) * (p - 1) / p
        nbr = beta * self.bytes_per_elem * self.nbr_elems(n) * (p > 1)
        return comp + lat + bw + nbr


def reference_comm_model() -> CommModel:
    """2 scalar psums + 1 all-gather of the full p vector per
    iteration (cg.cc:106,117,135 / sharded strategy='allgather')."""
    return CommModel("allgather", n_lat=3.0, bw_elems=lambda n: float(n))


def halo_comm_model(bandwidth: int) -> CommModel:
    """2 scalar psums + two bandwidth-wide neighbour ppermutes per
    iteration (sharded strategy='halo' on a DIA operator)."""
    return CommModel(
        "halo",
        n_lat=2.0,
        n_msgs=2.0,
        nbr_elems=lambda n, w=bandwidth: 2.0 * w,
    )


def pipelined_comm_model(bandwidth: int) -> CommModel:
    """ONE fused psum + the halo pair (method='pipelined')."""
    return CommModel(
        "pipelined",
        n_lat=1.0,
        n_msgs=2.0,
        nbr_elems=lambda n, w=bandwidth: 2.0 * w,
    )


def gvpipe_comm_model(
    bandwidth: int, replace_every: int = 25
) -> CommModel:
    """method='gvpipe' (Ghysels-Vanroose): the same ONE fused psum +
    halo pair as 'pipelined', but the psum has no same-iteration data
    dependence on the mat-vec (collective critical depth 1 in cgx's
    traced program, tests/test_collective_counts.py), so its tree latency rides
    behind the local compute (overlap=1: only the excess over compute
    is exposed). Costs ~12% more local work: two extra recurrence
    axpy pairs per iteration plus 4 guarded replacement mat-vecs per
    cadence, amortized here at half the cadence firing."""
    extra = 1.08 + (2.0 / replace_every if replace_every else 0.0)
    return CommModel(
        "gvpipe",
        n_lat=1.0,
        n_msgs=2.0,
        nbr_elems=lambda n, w=bandwidth: 2.0 * w,
        overlap=1.0,
        compute_factor=extra,
    )


def sstep_comm_model(bandwidth: int, s: int) -> CommModel:
    """method='sstep' with per-mat-vec halos, amortized per iteration:
    2(2s-1) ppermutes + 1 Gram psum per s-iteration block (the basis
    build does 2s-1 mat-vecs: s on p, s-1 on r)."""
    return CommModel(
        "sstep",
        n_lat=1.0 / s,
        n_msgs=2.0 * (2 * s - 1) / s,
        nbr_elems=lambda n, w=bandwidth, s=s: 2.0 * (2 * s - 1) * w / s,
    )


def sstep_deephalo_comm_model(bandwidth: int, s: int) -> CommModel:
    """method='sstep', sstep_powers='deephalo': 2 depth-(s*w) ppermutes
    (p and r stacked per direction) + 1 Gram psum per block — (1 tree
    + 2 messages)/s per iteration, message count independent of s, at
    4w words per iteration (vs 2(2s-1)w/s ~ 4w - 2w/s with per-mat-vec
    halos: ~2w/s extra words buy a (4s-4)-message latency saving per
    block). The win grows with alpha — the multi-host/DCN regime the
    reference's p>36 cliff exposed (plots.ipynb marker; report
    MPI-hard slide)."""
    return CommModel(
        "sstep_deephalo",
        n_lat=1.0 / s,
        n_msgs=2.0 / s,
        nbr_elems=lambda n, w=bandwidth: 4.0 * w,
    )


def fit_comm_model(
    rows: Sequence[Tuple[int, float]],
    n: int,
    iters: int,
    model: CommModel,
) -> Dict[str, float]:
    """Least-squares fit of (t1, alpha, beta) from measured
    (p, seconds) solve times of a fixed-(n, iters) problem.

    T(p)/iters is linear in the three unknowns with regressors
    (1/p, n_lat * log2 p, bytes-scaled traffic), so the fit is one
    lstsq; negative coefficients are clamped to 0 (a virtual mesh has
    no real latency/bandwidth cost to find). Returns the params plus
    the fit's relative RMS residual under 'rel_rms'."""
    ps = np.array([p for p, _ in rows], np.float64)
    ts = np.array([t for _, t in rows], np.float64) / float(iters)
    cols = [
        1.0 / ps,
        model.n_lat * np.log2(np.maximum(ps, 1.0))
        + model.n_msgs * (ps > 1),
        model.bytes_per_elem
        * (
            model.bw_elems(n) * (ps - 1) / ps
            + model.nbr_elems(n) * (ps > 1)
        ),
    ]
    a_mat = np.stack(cols, axis=1)
    # RELATIVE least squares (weight each row by 1/t): the serial row
    # is orders of magnitude above the scaled tail and would otherwise
    # dominate, flattening exactly the communication terms we are
    # trying to measure
    w = 1.0 / np.maximum(ts, 1e-30)
    coef, *_ = np.linalg.lstsq(a_mat * w[:, None], ts * w, rcond=None)
    coef = np.maximum(coef, 0.0)
    pred = a_mat @ coef
    rel_rms = float(
        np.sqrt(np.mean(((pred - ts) / np.maximum(ts, 1e-30)) ** 2))
    )
    return {
        "t1": float(coef[0]),
        "alpha": float(coef[1]),
        "beta": float(coef[2]),
        "rel_rms": rel_rms,
    }


def predict_scaling(
    model: CommModel,
    n: int,
    ps: Sequence[int],
    params: Dict[str, float],
    iters: int = 1,
) -> List[Tuple[int, float]]:
    """[(p, predicted seconds)] for a fixed-(n, iters) solve."""
    out = []
    for p in ps:
        t = model.iter_time(
            p,
            n,
            t1=params["t1"],
            alpha=params["alpha"],
            beta=params["beta"],
        )
        out.append((int(p), float(t) * iters))
    return out


def strategy_crossover(
    n: int,
    bandwidth: int,
    params: Dict[str, float],
    ps: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    sstep_s: int = 4,
) -> Dict[str, List[Tuple[int, float]]]:
    """Predicted per-iteration times of the strategies on one
    (alpha, beta, t1) machine — shows where halo/pipelined/s-step
    beat the reference-parity allgather pattern as p grows."""
    models = [
        reference_comm_model(),
        halo_comm_model(bandwidth),
        pipelined_comm_model(bandwidth),
        gvpipe_comm_model(bandwidth),
        sstep_comm_model(bandwidth, sstep_s),
        sstep_deephalo_comm_model(bandwidth, sstep_s),
    ]
    return {
        m.name: [
            (
                int(p),
                float(
                    m.iter_time(
                        p,
                        n,
                        t1=params["t1"],
                        alpha=params["alpha"],
                        beta=params["beta"],
                    )
                ),
            )
            for p in ps
        ]
        for m in models
    }


def fit_comm_model_joint(
    by_n: Dict[int, Sequence[Tuple[int, float]]],
    iters_by_n: Dict[int, int],
    model: CommModel,
) -> Dict[str, float]:
    """Joint fit of shared (alpha, beta) + per-N serial times across
    several problem sizes. A single-N sweep cannot separate latency
    from bandwidth (log2 p and (p-1)/p are nearly collinear over a
    handful of p values); across sizes the bandwidth column scales
    with N while the latency column does not, making both
    identifiable. Relative least squares as in :func:`fit_comm_model`.
    Returns {'alpha', 'beta', 't1:<n>': ..., 'rel_rms'}."""
    ns = sorted(by_n)
    rows_all, cols_t1, col_a, col_b = [], [], [], []
    for i, n in enumerate(ns):
        for p, t in by_n[n]:
            t_iter = t / float(iters_by_n[n])
            rows_all.append(t_iter)
            one_hot = [0.0] * len(ns)
            one_hot[i] = 1.0 / p
            cols_t1.append(one_hot)
            col_a.append(
                model.n_lat * np.log2(max(p, 1.0))
                + model.n_msgs * (p > 1)
            )
            col_b.append(
                model.bytes_per_elem
                * (
                    model.bw_elems(n) * (p - 1) / p
                    + model.nbr_elems(n) * (p > 1)
                )
            )
    a_mat = np.concatenate(
        [
            np.asarray(cols_t1),
            np.asarray(col_a)[:, None],
            np.asarray(col_b)[:, None],
        ],
        axis=1,
    )
    ts = np.asarray(rows_all)
    w = 1.0 / np.maximum(ts, 1e-30)
    coef, *_ = np.linalg.lstsq(a_mat * w[:, None], ts * w, rcond=None)
    coef = np.maximum(coef, 0.0)
    pred = a_mat @ coef
    rel_rms = float(
        np.sqrt(np.mean(((pred - ts) / np.maximum(ts, 1e-30)) ** 2))
    )
    out = {
        "alpha": float(coef[len(ns)]),
        "beta": float(coef[len(ns) + 1]),
        "rel_rms": rel_rms,
    }
    for i, n in enumerate(ns):
        out[f"t1:{n}"] = float(coef[i])
    return out
