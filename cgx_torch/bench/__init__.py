"""cgx_torch.bench: the measurement tooling of cgx on the port (counterpart
of ``cgx/bench``): the slope method, the dense kernel's tile autotuner,
the reference's scaling and kernel sweeps, per-row control gating, and
the analysis and report of the reference's CSV schemas."""

from cgx_torch.bench.analysis import (
    REFERENCE_ALPHAS,
    ScalingTable,
    amdahl_bound,
    fit_alpha,
    group_ladders,
    gustafson_bound,
    weak_efficiency,
)
from cgx_torch.bench.sweeps import kernel_sweep, strong_scaling, weak_scaling
from cgx_torch.bench.autotune import (
    autotune_dense_tiles,
    tuned_tiles,
)
