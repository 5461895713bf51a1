"""cgx_torch.ops (see the package docstring)."""
