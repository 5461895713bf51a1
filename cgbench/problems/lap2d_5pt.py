"""How the program builds the 2-D 5-point Laplacian: its own device
builder, once, in the solve's dtype, on the card."""

import cgx_torch


def operator(cfg: dict, dtype, device):
    return cgx_torch.lap2d_operator(int(cfg["grid"]), dtype, device=device)
