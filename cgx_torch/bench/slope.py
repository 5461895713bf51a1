"""The slope method of measuring a solve's time an iteration (counterpart
of ``cgx/bench/slope.py``).

A single solve's wall time holds fixed costs besides its iterations: the
host's launches before the card starts, the final fetch of the result,
and whatever the host was doing meanwhile. The slope method cancels them:
time fixed-iteration solves at maxiter = k1 and k2 > k1 and report

    s/iter = (T(k2) - T(k1)) / (k2 - k1)

The fixed cost is the same in both runs and subtracts out; per-rep
perturbed right-hand sides keep every run a fresh computation; the
median over reps rejects host jitter. Utilization is then the analytic
bytes an iteration (known exactly for the DIA format) over s/iter,
against the card's memory rate from :data:`HBM_GBPS`, the vendor's data
sheet keyed by ``torch.cuda.get_device_name()``. A device that is not in
the table raises, unless the caller passes ``peak_gbps``.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from cgx_torch.ops._util import resolve_device

# Peak memory rate by CUDA device name (GB/s, the vendor's data sheet). The
# roofline of a bandwidth-bound banded solve is its traffic over this rate.
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM: 3.35 TB/s of HBM3
}


def chip_hbm_gbps(default: Optional[float] = None, *, device="cuda") -> float:
    """The data-sheet memory rate of ``device`` from :data:`HBM_GBPS`;
    ``default`` for a device not in the table, which raises, naming the
    device, when ``default`` is None."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    for k, v in HBM_GBPS.items():
        if name.startswith(k):
            return v
    if default is None:
        raise ValueError(
            f"no memory rate for device {name!r} in HBM_GBPS; pass peak_gbps"
        )
    return default


def dia_cg_bytes_per_iter(
    n: int, ndiag: int, itemsize: int, precond_factor: float = 0.0
) -> float:
    """Analytic memory traffic of one banded CG iteration, in bytes.

    Mat-vec: read bands (ndiag * n) + read p (n, shifted reads hit the
    same cache lines) + write Ap (n). Recurrence: x += a p (r x, r p,
    w x), r -= a Ap (r r, r Ap, w r), p = r + b p (r r, r p, w p), two
    dots (reads already counted via operands r/p/Ap re-reads — counted
    once each: r p, r Ap, r r). Total = (ndiag + 13) * n * itemsize.
    This is the MINIMUM traffic assuming perfect fusion of elementwise
    chains into single passes; achieved/peak ratios above ~100% would
    indicate the model undercounts fusion, below ~50% real headroom.

    precond_factor adds that multiple of the mat-vec traffic for a
    preconditioner apply (e.g. 1.0 for one extra banded pass).
    """
    base = (ndiag + 13.0) * n * itemsize
    return base + precond_factor * (ndiag + 2.0) * n * itemsize


def _first_leaf(out):
    if isinstance(out, (tuple, list)):
        return _first_leaf(out[0])
    return out


def device_sync(out) -> None:
    """Execution barrier: ``torch.cuda.synchronize`` on the result's
    card, then a fetch of one scalar of it to the host. ``out`` is a
    tensor, an array or a tuple (a result record) of them; the first
    leaf is fetched."""
    leaf = _first_leaf(out)
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        leaf.reshape(-1)[0].item()
    else:
        np.asarray(leaf).ravel()[0]


def time_call(fn: Callable[[], object]) -> float:
    """Wall time of fn() including a fetch-based device sync."""
    t0 = time.perf_counter()
    device_sync(fn())
    return time.perf_counter() - t0


def slope_seconds_per_iter(
    run: Callable[[object, int], object],
    make_b: Callable[[int], np.ndarray],
    *,
    ks: Sequence[int] = (200, 400, 600),
    reps: int = 5,
    clock: Callable[[], float] = time.perf_counter,
    device="cuda",
) -> Dict[str, float]:
    """Median slope-method s/iter for a fixed-iteration solver.

    Args:
      run: (b on ``device``, maxiter) -> result; MUST run exactly
        maxiter iterations (tol=0 semantics).
      make_b: rep index -> right-hand side (NumPy); MUST vary per rep so
        that no rep repeats another's computation.
      device: where ``b`` is placed and the queue-draining op runs.

    The protocol: the right-hand side is moved to the device and
    synchronised before the timed region (the upload must pollute
    neither endpoint), a small device op drains the queue before each
    timing, each maxiter runs twice in warmup, and the ks are visited in
    snake order (ascending on even reps, descending on odd) so that a
    slow linear drift hits every k equally instead of biasing the slope.
    The headline ``s_per_iter`` is the Theil-Sen estimate, the median of
    all pairwise slopes across every (k, t) sample of every rep, which
    survives up to ~29% outlier samples (a per-rep least-squares line
    turns one sporadic spike into a negative or near-zero slope). The
    per-rep least-squares fits are still returned: 'floor' (the fixed
    per-solve cost), 'fit_rel_err' (max relative residual; a large value
    flags a measurement to distrust) and 's_per_iter_lsq' (the median of
    the per-rep least-squares slopes). 'ts_spread' is the relative IQR
    of the pairwise slopes, the Theil-Sen analogue of fit_rel_err.
    ``clock`` is injectable so that the slope and fit mathematics can be
    tested against a virtual clock, immune to host load.
    """
    dev = resolve_device(device)

    def put(b):
        d = torch.as_tensor(np.asarray(b), device=dev)
        device_sync(d)
        return d

    b0 = put(make_b(-1))
    for k in ks:  # first touch, twice each
        device_sync(run(b0, k))
        device_sync(run(b0, k))

    slopes, floors, errs = [], [], []
    samples = []  # (k, t) across all reps, for Theil-Sen
    for rep in range(reps):
        b = put(make_b(rep))
        order = list(ks) if rep % 2 == 0 else list(ks)[::-1]
        t_by_k = {}
        for k in order:
            device_sync(torch.zeros(8, device=dev) + float(len(t_by_k)))  # drain queue
            t0 = clock()
            out = run(b, k)
            device_sync(out)
            t_by_k[k] = clock() - t0
        ts = [t_by_k[k] for k in ks]
        samples.extend((float(k), t_by_k[k]) for k in ks)
        a_mat = np.stack([np.asarray(ks, float), np.ones(len(ks))], 1)
        coef, *_ = np.linalg.lstsq(a_mat, np.asarray(ts), rcond=None)
        pred = a_mat @ coef
        errs.append(
            float(np.max(np.abs(pred - ts) / np.maximum(ts, 1e-12)))
        )
        slopes.append(float(coef[0]))
        floors.append(float(coef[1]))
    pair_slopes = sorted(
        (t2 - t1) / (k2 - k1)
        for i, (k1, t1) in enumerate(samples)
        for (k2, t2) in samples[i + 1 :]
        if k2 != k1
    )
    ts_slope = statistics.median(pair_slopes)
    q1 = pair_slopes[len(pair_slopes) // 4]
    q3 = pair_slopes[(3 * len(pair_slopes)) // 4]
    return {
        "s_per_iter": ts_slope,
        "s_per_iter_lsq": statistics.median(slopes),
        "s_per_iter_all": slopes,
        "floor": statistics.median(floors),
        "fit_rel_err": max(errs),
        "ts_spread": (q3 - q1) / abs(ts_slope) if ts_slope else float("inf"),
        "ks": tuple(int(k) for k in ks),
        "reps": reps,
    }


def row_trusted(
    us_per_iter: float,
    ts_spread: float,
    pct_peak: float,
    *,
    spread_gate: float = 0.2,
    pct_peak_gate: float = 105.0,
) -> bool:
    """Trust gate for one slope-measured row. A row is trusted iff (a)
    the slope is positive, (b) the Theil-Sen pairwise-slope relative IQR
    is at most ``spread_gate``, and (c) the analytic utilization is
    physically sane: the traffic models overcount fused in-place updates
    by a few percent, so up to ``pct_peak_gate`` (105%) of the nominal
    peak is plausible; beyond that the number measures something other
    than the kernel.
    """
    return (
        us_per_iter > 0
        and ts_spread <= spread_gate
        and 0 < pct_peak <= pct_peak_gate
    )


def utilization_report(
    s_per_iter: float,
    bytes_per_iter: float,
    peak_gbps: Optional[float] = None,
    *,
    device="cuda",
) -> Dict[str, float]:
    """GB/s achieved and the fraction of the memory rate's peak
    (:func:`chip_hbm_gbps` of ``device`` unless ``peak_gbps`` is given)."""
    if peak_gbps is None:
        peak_gbps = chip_hbm_gbps(device=device)
    gbps = bytes_per_iter / s_per_iter / 1e9
    return {
        "achieved_gbps": gbps,
        "peak_gbps": peak_gbps,
        "fraction_of_peak": gbps / peak_gbps,
    }


def dense_cg_flops_per_iter(n: int) -> float:
    """Dense mat-vec dominates: 2 n^2 multiply-adds (+O(n) vector
    work, negligible)."""
    return 2.0 * n * n


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def _rhs_maker(n: int, dtype: np.dtype):
    rs = np.random.default_rng(0)

    def make_b(rep: int) -> np.ndarray:
        return (1.0 + 0.01 * (rep + 2)) * (
            rs.standard_normal(n).astype(dtype)
        )

    return make_b


def measure_dia_cg(
    dia,
    *,
    dtype="float64",
    ks: Sequence[int] = (200, 400, 600),
    reps: int = 5,
    precond=None,
    precond_factor: float = 0.0,
    device="cuda",
    peak_gbps: Optional[float] = None,
) -> Dict[str, float]:
    """Slope-measure single-device banded CG (the plain reference
    recurrence of :func:`cgx_torch.solver.cg.cg_solve`) on ``device``.

    Returns the slope dict + utilization fields. ``precond`` is an
    optional preconditioner callable passed to cg_solve; its extra
    traffic must be described by precond_factor for the utilization
    number to stay honest. ``peak_gbps`` overrides the table's rate.
    """
    from cgx_torch.solver.cg import cg_solve
    from cgx_torch.solver.operators import operator_from_numpy

    dev = resolve_device(device)
    np_dt = _np_dtype(dtype)
    n = dia.shape[0]
    ndiag = len(dia.offsets)
    op = operator_from_numpy(np.asarray(dia.bands, np_dt), tuple(dia.offsets), device=dev)

    def run(b, k):
        return cg_solve(op, b, tol=0.0, maxiter=k, precond=precond, device=dev).x

    out = slope_seconds_per_iter(run, _rhs_maker(n, np_dt), ks=ks, reps=reps, device=dev)
    bpi = dia_cg_bytes_per_iter(n, ndiag, np_dt.itemsize, precond_factor)
    out.update(utilization_report(out["s_per_iter"], bpi, peak_gbps, device=dev))
    out["bytes_per_iter"] = bpi
    out["n"] = n
    out["dtype"] = str(dtype)
    return out


def measure_dense_cg(
    a: np.ndarray,
    *,
    dtype="float32",
    block_rows: int = 256,
    block_cols: int = 512,
    kernel: str = "pallas",
    ks: Sequence[int] = (50, 100, 150),
    reps: int = 3,
    device="cuda",
    peak_gbps: Optional[float] = None,
) -> Dict[str, float]:
    """Slope-measure dense CG, the reference's own regime (a dense SPD A
    on one device, the CUDA_T.txt sweep's analogue): ``kernel="pallas"``
    runs the mat-vec through the hand-written dense kernel
    (:class:`~cgx_torch.solver.operators.PallasDenseOperator`, cgx's
    name), ``"xla"`` through ``torch.matmul``
    (:class:`~cgx_torch.solver.operators.DenseOperator`).

    Utilization is reported against the memory rate (reading A is the
    binding limit: one multiply-add per element read), with the flop
    rate beside it.
    """
    from cgx_torch.solver.cg import cg_solve
    from cgx_torch.solver.operators import DenseOperator, PallasDenseOperator

    dev = resolve_device(device)
    np_dt = _np_dtype(dtype)
    n = a.shape[0]
    a_dev = torch.as_tensor(np.ascontiguousarray(np.asarray(a, np_dt)), device=dev)
    if kernel == "pallas":
        op = PallasDenseOperator(a_dev, block_rows=block_rows, block_cols=block_cols)
    elif kernel == "xla":
        op = DenseOperator(a_dev)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")

    def run(b, k):
        return cg_solve(op, b, tol=0.0, maxiter=k, device=dev).x

    out = slope_seconds_per_iter(run, _rhs_maker(n, np_dt), ks=ks, reps=reps, device=dev)
    bpi = float(n) * n * np_dt.itemsize  # one full pass over A dominates
    out.update(utilization_report(out["s_per_iter"], bpi, peak_gbps, device=dev))
    out["bytes_per_iter"] = bpi
    out["gflops"] = dense_cg_flops_per_iter(n) / out["s_per_iter"] / 1e9
    out["n"] = n
    out["dtype"] = str(dtype)
    out["kernel"] = kernel
    out["block_rows"] = block_rows
    out["block_cols"] = block_cols
    return out
