"""Checks shared by the kernel wrappers: where the operands live, and
whether a CUDA kernel takes their types, shapes and layouts."""
from __future__ import annotations

import torch

#: element types the kernels read for values and dense operands
FLOAT_TYPES = (torch.float32, torch.bfloat16)

#: the value types of the nnz-balanced kernels (K1, K2, K4, K5), by the
#: code their entry points take: f32 and bf16 values, int8 and fp8 e4m3
#: codes that one f32 scale a tile decodes (``core/quant.py``)
VALUE_TYPES = {torch.float32: ("f32", 0), torch.bfloat16: ("bf16", 1),
               torch.int8: ("int8", 2)}
if hasattr(torch, "float8_e4m3fn"):
    VALUE_TYPES[torch.float8_e4m3fn] = ("fp8", 3)

_INT32_MAX = 2**31 - 1


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the wrapper then runs its
    plain version), False when all lie on one CUDA device (the wrapper
    launches its kernel); raises for any other placement."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands lie on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    return False


def check_operands(kernel: str, index: tuple, vals: torch.Tensor,
                   x: torch.Tensor, *, coded: bool = False,
                   scales: torch.Tensor | None = None) -> None:
    """Raise ``ValueError`` unless the kernel takes these operands: int32
    index arrays and ``vals`` of one shape, f32/bf16 values and dense
    operand, everything contiguous, sizes within int32.  With ``coded`` (K1,
    K2, K4, K5) the values may also be int8 or fp8 codes of an ``(n_tiles,
    tile)`` slab, given with their contiguous f32 ``scales`` of shape
    ``(n_tiles,)``."""
    for t in index:
        if t.dtype != torch.int32:
            raise ValueError(f"{kernel}: index arrays must be int32, got {t.dtype}")
        if t.shape != vals.shape:
            raise ValueError(f"{kernel}: index shape {tuple(t.shape)} != "
                             f"values shape {tuple(vals.shape)}")
    if coded and value_type(vals) in ("int8", "fp8"):
        if scales is None:
            raise ValueError(f"{kernel}: {vals.dtype} codes need their per-tile "
                             "scales")
        if (scales.dtype != torch.float32 or vals.ndim != 2
                or tuple(scales.shape) != (vals.shape[0],)
                or not scales.is_contiguous() or scales.device != vals.device):
            raise ValueError(f"{kernel}: scales must be contiguous float32 of "
                             f"shape ({vals.shape[0] if vals.ndim else 0},) on "
                             f"the values' device, got {scales.dtype} "
                             f"{tuple(scales.shape)}")
    elif vals.dtype not in FLOAT_TYPES:
        raise ValueError(f"{kernel}: values must be float32 or bfloat16"
                         + (", or int8 / fp8 codes" if coded else "")
                         + f", got {vals.dtype}")
    if x.dtype not in FLOAT_TYPES:
        raise ValueError(f"{kernel}: x must be float32 or bfloat16, got {x.dtype}")
    for t in (*index, vals, x):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{kernel}: an operand exceeds int32 indexing")


def check_dense(kernel: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """The dense operand a chain kernel aggregates (or K11 multiplies), as
    ``(K, N)``: raise ``ValueError`` unless ``x`` is ``(K,)`` or ``(K, N)``,
    contiguous float32 or bfloat16, with ``N`` within the launch grid (128
    columns a CTA)."""
    x2 = x[:, None] if x.ndim == 1 else x
    if x2.ndim != 2 or x2.shape[0] != k:
        raise ValueError(f"{kernel}: operand of shape {tuple(x.shape)} does "
                         f"not match K={k}")
    if x2.dtype not in FLOAT_TYPES or not x2.is_contiguous():
        raise ValueError(f"{kernel}: the dense operand must be contiguous "
                         f"float32 or bfloat16, got {x2.dtype}")
    if -(-x2.shape[1] // 128) > 65535:
        raise ValueError(f"{kernel}: N={x2.shape[1]} exceeds the launch grid")
    return x2


def is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def value_type(t: torch.Tensor) -> str | None:
    """``"f32"``, ``"bf16"``, ``"int8"`` or ``"fp8"`` for a value slab the
    nnz-balanced kernels read, else None."""
    hit = VALUE_TYPES.get(t.dtype)
    return hit[0] if hit else None


def value_code(t: torch.Tensor) -> int:
    """The ``vals_type`` argument of the nnz-balanced kernels' entry points
    (0 f32, 1 bf16, 2 int8, 3 fp8)."""
    return VALUE_TYPES[t.dtype][1]


def scales_ptr(vals: torch.Tensor, scales: torch.Tensor | None) -> int | None:
    """The ``scales`` argument of the nnz-balanced kernels' entry points:
    the scales' pointer for a slab of codes, None (a null pointer, not
    read) for a float slab."""
    return scales.data_ptr() if value_type(vals) in ("int8", "fp8") else None


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
