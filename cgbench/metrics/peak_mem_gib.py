"""The card's peak of allocated memory over set-up and window, in GiB
(``torch.cuda.max_memory_allocated``)."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
