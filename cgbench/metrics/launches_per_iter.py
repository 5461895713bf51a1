"""Kernel launches in the window (the sum of every ``cgx_torch.ops``
wrapper's ``.launches``) over the iterations the solves report."""


def read(rec):
    iters = sum(s["k"] for s in rec["solves"])
    return rec["launches"] / iters if rec["launches"] is not None and iters else None
