"""Value-stream quantization: per-tile symmetric int8 / fp8 codes with one
f32 scale a tile; counterpart of ``repro.core.quant``.

Two consumers, as in the reference:

* the **plan** — a quantized plan's balanced substrate stores int8 (or
  ``float8_e4m3fn``) codes with one f32 scale per nnz tile; on the card the
  nnz-balanced kernels K1, K2, K4 and K5 read the codes (1 B a nonzero in
  place of 4) and multiply each by its tile's scale in registers, so no f32
  copy of the stream is made;
* **training** — ``train/compress.py``'s per-tensor ``int8_encode`` /
  ``int8_decode`` are the objects defined here.

Codes and scales are bit-equal to the reference's, on the CPU and on the
card alike: ``amax / qmax`` and ``v / scale`` as f32 divisions of two
tensors (PyTorch's CUDA division by a Python number multiplies by its
reciprocal, which can round differently), ``torch.round`` (half to even, as
``jnp.round``), clipped to ±127 for int8; fp8 by ``.to(torch.float8_e4m3fn)``
(round to nearest even, as the reference's ``astype``).  A tile of zeros
(padding) has scale 1.0 and codes 0.

``check_tile_range`` guards a slab before it is quantized: a tile whose
``amax / median(|nonzero|)`` passes ``MAX_DYNAMIC_RANGE`` would lose most of
its entries to zero, so the plan warns, bumps the ``HEALTH`` counter
``quant_range_violations`` (``core/guardrails.py``) and keeps the float
stream (or, under ``sentinel="raise"``, raises ``NumericFault``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

#: quantized-substrate modes a plan accepts (``quant=``)
QUANT_MODES = ("int8", "fp8")

#: fp8 storage type: e4m3 (1 sign, 4 exponent, 3 mantissa bits, no
#: infinities), the OCP E4M3 bytes of CUDA's ``__nv_fp8_e4m3``
FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

#: symmetric ceiling a mode's codes reach: int8 clips at ±127, e4m3's
#: largest finite value is 448
QMAX = {"int8": 127.0, "fp8": 448.0}

#: per-tile dynamic range (amax / median |nonzero|) above which a slab is
#: not quantized: the int8 grid step is amax/127, so at 512 the typical
#: entry lies two steps below it and rounds to zero
MAX_DYNAMIC_RANGE = 512.0


def supports(mode: str) -> bool:
    """Whether this PyTorch can store the mode's value stream."""
    if mode == "int8":
        return True
    if mode == "fp8":
        return FP8_DTYPE is not None
    return False


def quant_dtype(mode: str) -> torch.dtype:
    """The storage type of one mode (raises on an unknown or unsupported
    mode)."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        if FP8_DTYPE is None:
            raise ValueError("fp8 substrates need a PyTorch with "
                             "float8_e4m3fn; use quant='int8'")
        return FP8_DTYPE
    raise ValueError(f"unknown quant mode {mode!r}; expected one of "
                     f"{QUANT_MODES}")


def is_quantized_dtype(dtype: torch.dtype) -> bool:
    """True for value types that need a scale to decode (int8 / fp8 codes):
    a baked coded slab, as opposed to a live f32 / bf16 stream."""
    return dtype == torch.int8 or (FP8_DTYPE is not None and dtype == FP8_DTYPE)


def value_bytes(dtype: torch.dtype) -> int:
    """Bytes an element of a value stream takes (4, 2 or 1)."""
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# per-tensor helpers (training-side compression)
# ---------------------------------------------------------------------------

def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``q = round(x / scale)``, ``scale =
    amax / 127`` (1.0 for an all-zero tensor), a 0-d f32 scale."""
    xf = x.float()
    amax = xf.abs().max() if xf.numel() else xf.new_zeros(())
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ---------------------------------------------------------------------------
# per-tile stream quantization (the substrate and kernel contract)
# ---------------------------------------------------------------------------

def quantize_stream(vals: torch.Tensor, mode: str
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a ``(..., tile)`` slab per tile of its last axis: ``(q,
    scales)``, ``q`` shaped like ``vals`` in the mode's storage type and
    ``scales`` f32 shaped like ``vals.shape[:-1]``.  Plain tensor ops on the
    slab's device: a plan's substrate is quantized once, a live stream on a
    quantized plan at every call."""
    qmax = QMAX[mode]
    dtype = quant_dtype(mode)
    v = vals.float()
    amax = v.abs().amax(dim=-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])
    scales = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                         torch.ones_like(amax))
    scaled = v / scales[..., None]
    if mode == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(dtype)
    else:
        q = scaled.to(dtype)
    return q, scales


def dequantize_stream(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode a coded slab to f32, ``code · scale`` (the plain versions and
    the backward's dX; the kernels do this multiply in registers)."""
    return q.float() * scales[..., None]


def check_tile_range(vals, bound: float = MAX_DYNAMIC_RANGE,
                     context: str = "substrate") -> bool:
    """Per-tile dynamic-range guard for a ``(..., tile)`` slab (a numpy
    array or a tensor on any device): True when every tile's ``amax /
    median(|nonzero|)`` (zeros excluded) stays within ``bound``; else warns,
    naming the worst ratio, and returns False."""
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().float().cpu().numpy()
    v = np.abs(np.asarray(vals, np.float64))
    nz = v > 0
    cnt = nz.sum(axis=-1)
    amax = v.max(axis=-1) if v.size else np.zeros(v.shape[:-1])
    with warnings.catch_warnings():
        # an all-zero tile gives an all-NaN nanmedian slice; masked below
        warnings.simplefilter("ignore", RuntimeWarning)
        med = np.nanmedian(np.where(nz, v, np.nan), axis=-1)
    med = np.where(cnt > 0, med, 1.0)
    ratio = np.where((cnt > 0) & (med > 0), amax / np.maximum(med, 1e-300), 0.0)
    worst = float(ratio.max()) if ratio.size else 0.0
    if worst > bound:
        from .guardrails import HEALTH
        HEALTH.bump("quant_range_violations")
        warnings.warn(
            f"quantization {context}: worst per-tile dynamic range "
            f"amax/rms = {worst:.1f} exceeds {bound:.0f}; keeping the "
            "unquantized value stream (small entries would collapse to "
            "zero on the int8/fp8 grid)", stacklevel=2)
        return False
    return True
