"""Checks shared by the kernel wrappers: where the operands live, and
whether a CUDA kernel takes their types, shapes and layouts."""
from __future__ import annotations

import torch

#: element types the kernels read for values and dense operands
FLOAT_TYPES = (torch.float32, torch.bfloat16)

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
                   x: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes these operands: int32
    index arrays and ``vals`` of one shape, f32/bf16 values and dense
    operand, everything contiguous, sizes within int32."""
    for t in index:
        if t.dtype != torch.int32:
            raise ValueError(f"{kernel}: index arrays must be int32, got {t.dtype}")
        if t.shape != vals.shape:
            raise ValueError(f"{kernel}: index shape {tuple(t.shape)} != "
                             f"values shape {tuple(vals.shape)}")
    for name, t in (("values", vals), ("x", x)):
        if t.dtype not in FLOAT_TYPES:
            raise ValueError(f"{kernel}: {name} must be float32 or bfloat16, "
                             f"got {t.dtype}")
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


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
