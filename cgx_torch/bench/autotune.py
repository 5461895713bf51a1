"""Tile autotuner for the dense mat-vec kernel B3 (counterpart of
``cgx/bench/autotune.py``).

The reference's CUDA harness swept (NUM_THREADS, BLOCK_WIDTH) by hand
and baked the winner into its report. Here the sweep is a library call
that measures :func:`cgx_torch.ops.matvec.dense_matvec` on the device
and keeps the winner per (device name, n, dtype) in a small JSON cache,
so that later runs (the CLI's ``--pallas`` without tiles) take the tuned
tiles without measuring again.

The cache is ``$CGX_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/cgx_torch/autotune.json``, keyed ``"<device name>|n|dtype"``
(``torch.cuda.get_device_name()``, or ``cpu``): cgx's cache is another
file, so neither package reads the other's winners.

A candidate is clamped as cgx clamps it and skipped only where
:func:`cgx_torch.ops.matvec.dense_plan` refuses it (its ``ValueError``);
any other failure, a build or a launch of the kernel, is raised. Each
timed run gets a freshly perturbed x and ends with a scalar fetch; the
median of ``repeats`` runs is kept (on the card each run is timed with
CUDA events around the launch).
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cgx_torch.ops._util import resolve_device

DEFAULT_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (128, 512),
    (256, 256),
    (256, 512),
    (256, 1024),
    (512, 512),
    (512, 1024),
    (1024, 512),
)
_DEFAULT_TILES = (256, 512)  # dense_matvec's static defaults
H100_SMS = 132  # the plan's SM count where no card is there to ask (an H100 SXM)


def _cache_path() -> str:
    env = os.environ.get("CGX_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "cgx_torch", "autotune.json"
    )


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _key(n: int, dtype, dev: torch.device) -> str:
    return f"{_device_name(dev)}|{n}|{str(_torch_dtype(dtype)).replace('torch.', '')}"


def tuned_tiles(
    n: int, dtype=np.float32, *, cache_path: Optional[str] = None, device="cuda"
) -> Tuple[int, int]:
    """Cached (block_rows, block_cols) for this device and problem, or
    the static defaults when nothing has been tuned yet (never measures)."""
    dev = resolve_device(device)
    data = _load(cache_path or _cache_path())
    hit = data.get(_key(n, dtype, dev))
    if hit:
        return (int(hit["block_rows"]), int(hit["block_cols"]))
    return _DEFAULT_TILES


def _sms(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def feasible(n: int, block_cols: int, dtype, dev: torch.device) -> bool:
    """Whether :func:`~cgx_torch.ops.matvec.dense_plan` takes an (n, n)
    matrix with ``block_cols``-column tiles on this device: False where
    it raises its ``ValueError``."""
    from cgx_torch.ops import matvec

    try:
        matvec.dense_plan(n, n, int(block_cols), _torch_dtype(dtype), _sms(dev))
    except ValueError:
        return False
    return True


def _time_matvec(a, x, br: int, bc: int, dev: torch.device) -> float:
    """Seconds of one dense_matvec, ended by a scalar fetch."""
    from cgx_torch.ops.matvec import dense_matvec

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = dense_matvec(a, x, block_rows=br, block_cols=bc)
        end.record()
        float(y[0])  # scalar fetch ends the timed region
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    y = dense_matvec(a, x, block_rows=br, block_cols=bc)
    float(y[0])
    return time.perf_counter() - t0


def autotune_dense_tiles(
    n: int,
    dtype=np.float32,
    *,
    candidates: Optional[Sequence[Tuple[int, int]]] = None,
    repeats: int = 3,
    cache_path: Optional[str] = None,
    force: bool = False,
    device="cuda",
) -> Tuple[int, int]:
    """Measure the dense mat-vec kernel across tile candidates on
    ``device`` (on lap2d_reference(n) densified, x = source_term(n)) and
    persist the winner.

    Returns the chosen (block_rows, block_cols); cached results are
    returned immediately unless ``force``.
    """
    from cgx_torch.mats.generators import lap2d_reference, source_term
    from cgx_torch.ops.matvec import dense_matvec

    dev = resolve_device(device)
    t_dtype = _torch_dtype(dtype)
    path = cache_path or _cache_path()
    key = _key(n, dtype, dev)
    data = _load(path)
    if not force and key in data:
        hit = data[key]
        return (int(hit["block_rows"]), int(hit["block_cols"]))
    if candidates is None:
        candidates = DEFAULT_CANDIDATES

    a = torch.as_tensor(lap2d_reference(n).to_dense(), dtype=t_dtype, device=dev).contiguous()
    x0 = np.asarray(source_term(n))
    rng = np.random.default_rng(time.time_ns() % (2**63))

    results: List[Tuple[float, Tuple[int, int]]] = []
    for br, bc in candidates:
        br_c = max(8, min(br, n))
        bc_c = max(128, min(bc, n))
        if not feasible(n, bc_c, t_dtype, dev):
            continue
        x = torch.as_tensor(x0, dtype=t_dtype, device=dev)
        float(dense_matvec(a, x, block_rows=br_c, block_cols=bc_c)[0])  # first touch
        times = []
        for _ in range(repeats):
            x = torch.as_tensor(x0 * (1.0 + 1e-6 * rng.standard_normal(n)), dtype=t_dtype,
                                device=dev)
            float(x[0])  # upload before the clock starts
            times.append(_time_matvec(a, x, br_c, bc_c, dev))
        times.sort()
        results.append((times[len(times) // 2], (br_c, bc_c)))

    if not results:
        return _DEFAULT_TILES
    best_t, (br, bc) = min(results)
    data[key] = {
        "block_rows": br,
        "block_cols": bc,
        "seconds": best_t,
        "candidates_tried": len(results),
        "tuned_at": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    _store(path, data)
    return (br, bc)
