"""Chronopoulos-Gear CG streamed from device memory, float32 vectors: one
pass over the bands and the vectors an iteration, since the vectors do not
stay on chip.

An iteration reads the bands once and p, x, r, w and s and writes them
once: ``(ndiag * band_bytes + 10 * 4) * n`` bytes. Operations, as cgx's
cost estimate counts them: ``(2 * ndiag + 8) * n`` in float32.
"""


def count(n: int, ndiag: int, iters: int, solves: int, *, band_bytes: int) -> dict:
    return {"bytes": iters * n * (ndiag * band_bytes + 10 * 4),
            "ops": {"float32": iters * (2 * ndiag + 8) * n}}
