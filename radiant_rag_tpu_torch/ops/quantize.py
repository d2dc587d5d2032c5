"""Embedding quantization: sign-bit packing and calibrated int8.

Counterpart of `radiant_rag_tpu/ops/quantize.py`. Codes are bit-identical to
the JAX package's: `torch.round` rounds half to even like `jnp.round`, and
the operations run in the same order, `(x - lo) / scale` (not a multiply by
the reciprocal). One rewrite is mirrored: under `jit`, XLA turns a division
by a constant into a multiply by the constant's f32 reciprocal, so the
quantization scale is `(hi - lo) * f32(1/255)` here too (`int8_scale_offset`,
which the JAX package calls outside `jit`, divides).

  binary: bit d = (x_d > 0), packed into 32-bit words
  int8:   q_d = round((x_d - lo_d) / s_d) - 128, s_d = (hi_d - lo_d) / 255
          dequant x_d = q_d * s_d + o_d, o_d = lo_d + 128 * s_d
"""

from __future__ import annotations

from typing import Tuple

import torch

WORD_BITS = 32
INV_255 = float(torch.tensor(1.0 / 255.0, dtype=torch.float32))  # XLA's reciprocal


def packed_words(dim: int) -> int:
    """Number of 32-bit words for `dim` sign bits."""
    return (dim + WORD_BITS - 1) // WORD_BITS


def pack_binary(x: torch.Tensor) -> torch.Tensor:
    """(N, D) float -> (N, ceil(D/32)) sign-bit words (bit d of word w is set
    iff x[:, 32w + d] > 0). torch has no uint32 arithmetic, so the words are
    int32 tensors holding the same 32 bits as the JAX package's uint32."""
    n, d = x.shape
    if d % WORD_BITS:
        x = torch.nn.functional.pad(x, (0, WORD_BITS - d % WORD_BITS), value=-1.0)
        d = x.shape[1]
    bits = (x > 0).to(torch.int64).reshape(n, d // WORD_BITS, WORD_BITS)
    weights = torch.bitwise_left_shift(
        torch.ones(WORD_BITS, dtype=torch.int64, device=x.device),
        torch.arange(WORD_BITS, device=x.device))
    words = (bits * weights).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def calibrate_int8_ranges(sample: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension (lo, hi) over a sample; degenerate dims widened by 1e-6
    so the scale is never zero."""
    lo = sample.min(dim=0).values
    hi = sample.max(dim=0).values
    hi = torch.where(hi - lo < 1e-6, lo + 1e-6, hi)
    return lo, hi


def quantize_int8(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Affine int8 quantization over per-dim ranges; (N, D) int8."""
    scale = (hi - lo) * INV_255
    q = torch.round((x - lo) / scale) - 128.0
    return q.clamp(-128.0, 127.0).to(torch.int8)


def dequantize_int8(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_int8` (midpoint reconstruction)."""
    scale = (hi - lo) * INV_255
    return q.to(torch.float32) * scale + (lo + 128.0 * scale)


def int8_scale_offset(lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, o) such that dequant(q) = q * s + o."""
    s = (hi - lo) / 255.0
    return s, lo + 128.0 * s
