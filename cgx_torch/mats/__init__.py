"""cgx_torch.mats (see the package docstring)."""
