"""The mean of the solves' iteration counts (``CGResult.iterations``)."""


def read(rec):
    return sum(s["k"] for s in rec["solves"]) / len(rec["solves"]) if rec["solves"] else None
