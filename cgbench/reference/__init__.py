"""The benchmark's plain references: problems and CG in plain PyTorch.

Nothing here imports the program under test (``cgx_torch``), JAX or the
JAX package. A reference builds its problem again from the configuration's
parameters and takes from the benchmark only the right-hand sides it also
hands to the program.
"""
