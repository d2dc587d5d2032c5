"""The arithmetic of each stage of the reference.

`FULL` is the reference: float32 everywhere, TF32 off (the configuration
states bfloat16 compute for the encoders and float32 for the rest). The
control is the reference one step lower in each stage: the encoders'
products in fp8 (e4m3, one scale per operand, the step below bfloat16), the
dense rescore in TF32 (below float32 with TF32 off), the BM25 rescore and
the fusion in bfloat16 (below other float32).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    encoder: str = "float32"  # float32 | bfloat16 | fp8
    rescore: str = "float32"  # float32 | tf32
    lexical: str = "float32"  # float32 | bfloat16
    fusion: str = "float32"  # float32 | bfloat16


FULL = Precision()
# the harness's input generator (corpus vectors from the encoder): bfloat16
# products, the precision the configuration serves the encoder in
INPUTS = Precision(encoder="bfloat16")
CONTROL = Precision(encoder="fp8", rescore="tf32", lexical="bfloat16", fusion="bfloat16")

FP8_MAX = 448.0  # largest finite e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale that maps its largest magnitude to
    FP8_MAX, returned in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties to even), as
    float32: what a TF32 tensor-core product reads of its operands, whatever
    routine the library would pick for the shape."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def rounded(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """x rounded to `dtype` ("float32" leaves it), as float32."""
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


@contextlib.contextmanager
def tf32_off():
    """float32 products stay float32 inside the block (TF32 off); the
    previous setting comes back after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
