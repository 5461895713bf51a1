"""Plain CG whose float32 vectors stay on chip for the whole solve (the
vectors of N = 1e6 fit the card's shared memory and registers).

Bytes: each solve reads the bands, p, x and r once and writes p, x and r
once: ``(ndiag * band_bytes + 6 * 4) * n``. Operations an iteration a
row: ``2 * ndiag + 6`` in float32 (Ap, the x, r and p updates) and the
dots <p, Ap> and <r, r> in float64, a product and a sum each.
"""


def count(n: int, ndiag: int, iters: int, solves: int, *, band_bytes: int) -> dict:
    return {"bytes": solves * n * (ndiag * band_bytes + 6 * 4),
            "ops": {"float32": (2 * ndiag + 6) * n * iters, "float64": 4 * n * iters}}
