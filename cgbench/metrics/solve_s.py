"""Mean time to solution: the window's seconds over the solves it finished."""


def read(rec):
    return rec["window_s"] / len(rec["solves"]) if rec["solves"] else None
