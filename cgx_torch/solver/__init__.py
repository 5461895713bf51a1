"""cgx_torch.solver (see the package docstring)."""
