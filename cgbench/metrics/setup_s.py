"""Seconds from the start of the process to the end of the warm-up solve:
imports, the kernels' load (their build on a checkout's first run), the
operator built on the card and one solve."""


def read(rec):
    return rec["setup_s"]
