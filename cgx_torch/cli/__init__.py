"""cgx_torch.cli: the reference-grammar command line (see ``main``)."""
