"""Helpers shared by the kernel wrappers and the solvers."""

from __future__ import annotations

import collections
import contextlib
from typing import Optional

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) needs a card: without one this raises instead of
    running on the CPU; pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cgx_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cgx_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def check_device(t: torch.Tensor, dev: torch.device, name: str) -> None:
    """Raise if tensor ``t`` is not on ``dev``: nothing moves silently."""
    if t.device.type != dev.type or (
        dev.index is not None and t.device.index != dev.index
    ):
        raise ValueError(f"{name} is on {t.device}, but the call runs on {dev}")


# the C entry suffix of each vector dtype (csrc/*.cu; _bf16 only where _build binds one)
KERNEL_DTYPES = {torch.float32: "_f32", torch.float64: "_f64", torch.bfloat16: "_bf16"}
FLOAT_VECTORS = (torch.float32, torch.float64)  # the vector dtypes every kernel is built for
SHARED_OPTIN = 232448  # bytes of shared memory one block may take on the H100 (227 KB)
MIN_TILE = 1024  # rows of the smallest slab of a slab kernel: a small n takes fewer blocks
# the C entry suffix of each narrower band dtype under float32 vectors
NARROW_BANDS = {torch.bfloat16: "_f32_bf16b", torch.float16: "_f32_f16b"}
BF16_BANDS_SUFFIX = NARROW_BANDS[torch.bfloat16]


def vector_dtypes(*entries: str) -> tuple:
    """The vector dtypes that every one of the C entries ``entries`` is
    built for: float32 and float64, and bfloat16 where each has a ``_bf16``
    build (``cgx_torch._build``'s ``BF16_VECTORS``)."""
    from cgx_torch._build import BF16_VECTORS

    if entries and all(e in BF16_VECTORS for e in entries):
        return (*FLOAT_VECTORS, torch.bfloat16)
    return FLOAT_VECTORS


def band_dtypes(*entries: str) -> tuple:
    """The narrower band dtypes under float32 vectors that every one of the
    C entries ``entries`` is built for (``cgx_torch._build``'s ``BF16_BANDS``
    and ``F16_BANDS``)."""
    from cgx_torch._build import BF16_BANDS, F16_BANDS

    built = {torch.bfloat16: BF16_BANDS, torch.float16: F16_BANDS}
    return tuple(d for d, names in built.items() if entries and all(e in names for e in entries))


def entry_suffix(vec_dtype: torch.dtype, bands_dtype: torch.dtype) -> str:
    """The C entry suffix for these vectors and bands: the vectors' own,
    or :data:`NARROW_BANDS`'s for bfloat16 or float16 bands under float32
    vectors."""
    if bands_dtype == vec_dtype:
        return KERNEL_DTYPES[vec_dtype]
    if vec_dtype == torch.float32 and bands_dtype in NARROW_BANDS:
        return NARROW_BANDS[bands_dtype]
    raise NotImplementedError(_unbuilt(vec_dtype, bands_dtype))


def _unbuilt(vec_dtype: torch.dtype, bands_dtype) -> str:
    return (f"bands_dtype={bands_dtype} under {vec_dtype} vectors: cgx_torch's kernels take "
            "bfloat16 or float16 bands under float32 vectors only (no route of solve asks for "
            "another pair; ROADMAP C)")


def band_storage(vec_dtype: torch.dtype, bands_dtype) -> Optional[torch.dtype]:
    """The narrower band dtype a kernel is asked to stream (None for the
    vectors' own, which includes bfloat16 bands under bfloat16 vectors):
    bfloat16 or float16 under float32 vectors; any other pair raises,
    naming it."""
    if bands_dtype is None or bands_dtype == vec_dtype:
        return None
    if vec_dtype == torch.float32 and bands_dtype in NARROW_BANDS:
        return bands_dtype
    raise NotImplementedError(_unbuilt(vec_dtype, bands_dtype))


# launches of each build, keyed by site and C entry suffix ("dia_matvec_bf16",
# "dia_cg_vmem2d_f32_bf16b", ...): the wrappers whose sites have a bfloat16 build
# count here beside their ``.launches``, on the CPU as the plain version's runs
BUILD_LAUNCHES: collections.Counter = collections.Counter()


def count_build(site: str, vec_dtype: torch.dtype, bands_dtype: torch.dtype,
                launches: int = 1) -> None:
    """Add ``launches`` to the count of ``site``'s build for these vectors
    and bands in :data:`BUILD_LAUNCHES`."""
    BUILD_LAUNCHES[site + entry_suffix(vec_dtype, bands_dtype)] += launches


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def slab_grid(n: int, blocks: int, min_slab: int = MIN_TILE) -> int:
    """Blocks of a slab kernel on n rows: ``blocks``, fewer where a slab
    would have fewer than ``min_slab`` rows."""
    return max(1, min(blocks, -(-n // min_slab)))


def sms_of(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pow2_rhs_scale(b: torch.Tensor, x0: Optional[torch.Tensor] = None):
    """Exact power-of-2 ``(down, up)`` pair that brings ``max|b|`` (and
    ``max|x0|``) into [0.5, 1): ``down = 2**-e``, ``up = 2**e`` from the
    ``frexp`` exponent ``e``, as 0-d tensors of ``b``'s dtype on its
    device; ``(1, 1)`` for a zero ``b``. Scaling by a power of two
    commutes with rounding (absent over- and underflow), so a scaled
    solve scaled back is bitwise the unscaled one for a well-scaled
    ``b``, while ``<r, r>`` of a huge ``b`` stays inside float32's range
    (counterpart of ``cgx/ops/_util.py:pow2_rhs_scale``)."""
    amax = torch.max(torch.abs(b)) if b.numel() else torch.zeros((), dtype=b.dtype,
                                                                 device=b.device)
    if x0 is not None:
        amax = torch.maximum(amax, torch.max(torch.abs(x0)))
    _, e = torch.frexp(amax)  # amax = m * 2**e, m in [0.5, 1)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    return torch.ldexp(one, -e), torch.ldexp(one, e)


def check_operands(fn: str, vectors: dict, scalars: dict = None,
                   dtypes: tuple = FLOAT_VECTORS) -> None:
    """Validate the tensors a kernel wrapper takes, before any pointer
    reaches C: one dtype of ``dtypes`` (the vector dtypes its kernels are
    built for, :func:`vector_dtypes`) and one device (CPU or CUDA) for
    all, set by the first vector; vectors 1-D, contiguous and of one
    length; scalars with one element."""
    first = None
    for name, t in {**vectors, **(scalars or {})}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {name} must be a torch.Tensor, got {type(t)}")
        if first is None:
            first = t
            if t.dtype not in dtypes:
                names = "/".join(str(d).removeprefix("torch.") for d in dtypes)
                raise TypeError(f"{fn}: dtype {t.dtype} (its kernels take {names})")
            if t.device.type not in ("cpu", "cuda"):
                raise ValueError(f"{fn}: {name} is on {t.device} (cpu or cuda only)")
        if t.dtype != first.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {first.dtype}")
        if t.device != first.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected {first.device}")
        if name in vectors:
            if t.dim() != 1 or t.shape != first.shape:
                raise ValueError(
                    f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(first.shape)}"
                )
            if not t.is_contiguous():
                raise ValueError(f"{fn}: {name} must be contiguous")
        elif t.numel() != 1:
            raise ValueError(f"{fn}: {name} must hold one element, has {t.numel()}")


def launch(entry: str, like: torch.Tensor, *args, suffix: Optional[str] = None) -> None:
    """Call the C entry point ``entry`` of ``like``'s dtype (or of the
    given ``suffix``, e.g. :data:`BF16_BANDS_SUFFIX`) on the current
    stream of ``like``'s CUDA device; raise if it reports an error.
    Builds the kernels on first use."""
    from cgx_torch import _build

    fn = getattr(_build.load(), entry + (suffix or KERNEL_DTYPES[like.dtype]))
    with torch.cuda.device(like.device):
        rc = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: the CUDA launch failed with cudaError {rc}")


@contextlib.contextmanager
def f32_exact():
    """Run float32 matrix products at full float32 inside the block.

    TF32 keeps about three decimal digits, and a reduced-precision
    product inside a recurrence stalls CG at high condition numbers
    (the lesson of ``cgx/ops/_util.py:f32_exact``). The solver loops
    run inside this; the old setting comes back on exit. Precision
    "highest" also turns ``torch.backends.cuda.matmul.allow_tf32`` off;
    setting that flag directly as well would mix PyTorch's old and new
    precision APIs, which PyTorch refuses to read back.
    """
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
