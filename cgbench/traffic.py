"""The right-hand sides of a closed loop of solves.

Solve ``j`` gets ``b_j = b0 + noise_rel * rms(b0) * z_j``: ``b0`` the
configuration's source term (from its plain reference), ``z_j`` standard
normal from a generator on the device seeded by ``(rhs.sequence_seed,
j)``, in the solve's dtype. The sequence is the mix's, not the run's:
every ``--seed`` solves the same ``b_0, b_1, ...`` in a window (the
recurrence's iteration count differs by a few per cent from one
right-hand side to another, so a sequence drawn from the run's seed
would move a run's mean with it), and no right-hand side comes twice in
a run. The run's seed draws which answers are judged (``judge``). The
absolute tolerance is ``tolerance_rel * ||b_j||``. The same index gives
the same ``b_j`` on the same device, so the reference is handed again
exactly what the program was handed.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"fp64": torch.float64, "fp32": torch.float32, "bf16": torch.bfloat16}
WARMUP = -1  # the index of the set-up's warm-up solve, outside the window's sequence


def stream_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for the stream ``key`` of ``seed`` (any whole numbers)."""
    words = [int(seed) % 2**64, *(int(k) % 2**64 for k in key)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


class Rhs:
    def __init__(self, mix: dict, source: torch.Tensor):
        rhs = mix["rhs"]
        self.dtype = DTYPES[mix["solve"]["precision"]]
        self.tol_rel = float(mix["tolerance_rel"])
        self.sequence_seed = int(rhs["sequence_seed"])
        self.base = source.to(self.dtype)
        rms = float(torch.sqrt(torch.mean(source.to(torch.float64) ** 2)))
        self.scale = float(rhs["noise_rel"]) * rms

    def make(self, j: int):
        """``(b_j, tol_j)``; reading the tolerance waits for ``b_j``."""
        gen = torch.Generator(device=self.base.device)
        gen.manual_seed(stream_seed(self.sequence_seed, j))
        b = torch.randn(self.base.shape, generator=gen, dtype=self.dtype,
                        device=self.base.device)
        b.mul_(self.scale).add_(self.base)
        return b, self.tol_rel * float(torch.linalg.vector_norm(b))
