"""Chronopoulos-Gear CG with the two-term Neumann preconditioner, streamed
from device memory, float32 vectors: one pass an iteration.

An iteration reads the bands once and p, x, u, r, w and s and writes them
once: ``(ndiag * band_bytes + 12 * 4) * n`` bytes. Operations, as cgx's
cost estimate counts them: ``(4 * ndiag + 14) * n`` in float32.
"""


def count(n: int, ndiag: int, iters: int, solves: int, *, band_bytes: int) -> dict:
    return {"bytes": iters * n * (ndiag * band_bytes + 12 * 4),
            "ops": {"float32": iters * (4 * ndiag + 14) * n}}
