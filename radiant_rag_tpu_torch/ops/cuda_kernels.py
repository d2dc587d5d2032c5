"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

  int8_scan_topk  csrc/int8_scan_topk.cu  <- pallas_kernels.int8_scan_topk_pallas
  blockmax2       csrc/blockmax2.cu       <- pallas_kernels.blockmax2_pallas

A wrapper runs the plain PyTorch version only for CPU tensors. For CUDA
tensors it launches the kernel or raises; nothing falls back. Each wrapper
counts its launches in `<wrapper>.launches`, so a run can show that its
path went through the kernel.

The plain versions compute the same function the obvious way: the integer
dot products as an fp32 matmul (exact: |score| <= 127 * 128 * D < 2^24 for
D <= 1024, so every partial sum is an exactly representable integer), then a
top-k over unique int64 keys (score, then row ascending) so that ties break
by the lowest row exactly as the kernels and `lax.top_k` do.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from radiant_rag_tpu_torch import _build

NEG = -3.0e38  # score of an empty output slot (pallas_kernels.NEG)
BLOCKMAX_TILE = 512  # rows per block-max tile: part of the selection semantics
INT8_SCAN_TOPK_MAX_K = 256  # per-query list length the kernel's shared memory holds
_MERGE_MAX = 4096  # largest splits * k the merge launch sorts in shared memory
_REF_QUERY_CHUNK = 256  # query rows per plain-version step (bounds its (B, N) buffer)
_P = ctypes.c_void_p


def _keys(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Unique int64 order keys of a (B, N) exact-integer score block: larger
    is better; a row's key beats every higher row's key at equal score.
    Masked rows get the int64 minimum."""
    n = scores.shape[1]
    rows = torch.arange(n, device=scores.device, dtype=torch.int64)
    keys = scores.to(torch.int64) * (1 << 32) + ((1 << 32) - 1 - rows)
    if mask is not None:
        keys = torch.where(mask.bool()[None, :], keys, torch.iinfo(torch.int64).min)
    return keys


def _decode(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    empty = keys == torch.iinfo(torch.int64).min
    score = torch.div(keys, 1 << 32, rounding_mode="floor")
    row = (1 << 32) - 1 - (keys - score * (1 << 32))
    return (torch.where(empty, NEG, score.to(torch.float32)),
            torch.where(empty, -1, row).to(torch.int32))


def _dots(codes_t: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Exact integer dots against fp32 transposed codes (see module doc)."""
    return qi.to(torch.float32) @ codes_t


def int8_scan_topk_reference(codes: torch.Tensor, qi: torch.Tensor,
                             mask: Optional[torch.Tensor], k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `int8_scan_topk`."""
    n = codes.shape[0]
    kk = min(k, n)
    codes_t = codes.to(torch.float32).T
    outs_s, outs_r = [], []
    for q0 in range(0, max(qi.shape[0], 1), _REF_QUERY_CHUNK):
        keys = _keys(_dots(codes_t, qi[q0:q0 + _REF_QUERY_CHUNK]), mask)
        s, r = _decode(torch.topk(keys, kk, dim=1).values)
        outs_s.append(s)
        outs_r.append(r)
    s, r = torch.cat(outs_s), torch.cat(outs_r)
    if kk < k:
        s = torch.nn.functional.pad(s, (0, k - kk), value=NEG)
        r = torch.nn.functional.pad(r, (0, k - kk), value=-1)
    return s, r


def blockmax2_reference(codes: torch.Tensor, qi: torch.Tensor,
                        mask: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `blockmax2`; a ragged last tile is padded with
    invalid rows."""
    n = codes.shape[0]
    nt = -(-n // BLOCKMAX_TILE)
    pad = nt * BLOCKMAX_TILE - n
    m = torch.ones(n, dtype=torch.bool, device=codes.device) if mask is None else mask.bool()
    m = torch.nn.functional.pad(m, (0, pad), value=False)
    local = torch.arange(BLOCKMAX_TILE, device=codes.device, dtype=torch.int64)
    base = torch.arange(nt, device=codes.device, dtype=torch.int64)[:, None] * BLOCKMAX_TILE
    codes_t = codes.to(torch.float32).T
    outs_s, outs_r = [], []
    for q0 in range(0, max(qi.shape[0], 1), _REF_QUERY_CHUNK):
        sc = torch.nn.functional.pad(_dots(codes_t, qi[q0:q0 + _REF_QUERY_CHUNK]), (0, pad))
        sc = sc.reshape(sc.shape[0], nt, BLOCKMAX_TILE).to(torch.int64)
        keys = sc * (1 << 32) + ((1 << 32) - 1 - local)
        keys = torch.where(m.reshape(nt, BLOCKMAX_TILE), keys, torch.iinfo(torch.int64).min)
        s, r = _decode(torch.topk(keys, 2, dim=2).values)  # (b, nt, 2), local rows
        r = torch.where(r >= 0, r + base, -1).to(torch.int32)
        outs_s.append(torch.cat([s[:, :, 0], s[:, :, 1]], dim=1))
        outs_r.append(torch.cat([r[:, :, 0], r[:, :, 1]], dim=1))
    return torch.cat(outs_s), torch.cat(outs_r)


def _check(codes: torch.Tensor, qi: torch.Tensor, mask: Optional[torch.Tensor]):
    if codes.dtype != torch.int8 or qi.dtype != torch.int8:
        raise TypeError(f"int8 codes and queries expected, got {codes.dtype}, {qi.dtype}")
    if codes.dim() != 2 or qi.dim() != 2 or codes.shape[1] != qi.shape[1]:
        raise ValueError(f"shapes {tuple(codes.shape)} and {tuple(qi.shape)} do not match")
    if not (codes.is_contiguous() and qi.is_contiguous()):
        raise ValueError("codes and queries must be contiguous")
    if qi.device != codes.device:
        raise ValueError("codes and queries must be on one device")
    n, d = codes.shape
    if d % 16 or d > 1024 or d == 0:
        raise ValueError(f"the kernels take 0 < D <= 1024 with D % 16 == 0, got {d}")
    if n >= 2**31 - 1:
        raise ValueError(f"{n} rows exceed the kernels' int32 row ids")
    if mask is None:
        return None
    if mask.shape != (n,) or mask.device != codes.device:
        raise ValueError(f"mask of shape {tuple(mask.shape)} does not match {n} rows")
    if mask.dtype not in (torch.bool, torch.uint8, torch.int8):
        raise TypeError(f"bool / uint8 mask expected, got {mask.dtype}")
    return mask.contiguous().view(torch.uint8)


def _lib(stem: str, entry: str, argtypes):
    fn = getattr(_build.library(stem), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def scan_topk_splits(n: int, b: int, k: int, num_sms: int) -> int:
    """Corpus splits of the partial launch: enough CTAs for two per SM, no
    more splits than 64-row tiles, and splits * k within the merge's sort."""
    qblocks = -(-b // 32)
    want = -(-2 * num_sms // qblocks)
    return max(1, min(want, -(-n // 64), _MERGE_MAX // k))


def int8_scan_topk(codes: torch.Tensor, qi: torch.Tensor,
                   mask: Optional[torch.Tensor], k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of qi . codes^T per query without a (B, N) matrix.

    codes (N, D) int8, qi (B, D) int8, mask (N,) bool/uint8 or None.
    Returns ((B, k) f32 raw integer scores, (B, k) int32 rows), ordered by
    score descending then row ascending; empty slots are (-3e38, -1)."""
    if codes.device.type == "cpu":
        return int8_scan_topk_reference(codes, qi, mask, k)
    m8 = _check(codes, qi, mask)
    if not 1 <= k <= INT8_SCAN_TOPK_MAX_K:
        raise ValueError(f"k={k} outside the kernel's 1..{INT8_SCAN_TOPK_MAX_K}")
    n, d = codes.shape
    b = qi.shape[0]
    dev = codes.device
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_r
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = scan_topk_splits(n, b, k, sms)
    rows_per_split = -(-n // (splits * 64)) * 64
    merge_p = 1 << max(0, (splits * k - 1).bit_length())
    part_s = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    part_r = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    fn = _lib("int8_scan_topk", "rr_int8_scan_topk",
              [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(codes.data_ptr(), qi.data_ptr(), _ptr(m8), n, d, b, k, splits,
                 rows_per_split, merge_p, part_s.data_ptr(), part_r.data_ptr(),
                 out_s.data_ptr(), out_r.data_ptr(), stream)
    _raise_on(err, "int8_scan_topk")
    int8_scan_topk.launches += 1
    return out_s, out_r


int8_scan_topk.launches = 0


def blockmax2(codes: torch.Tensor, qi: torch.Tensor, mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-512-row-tile top-2 of qi . codes^T.

    Returns ((B, 2*NT) f32 exact integer scores, (B, 2*NT) int32 global
    rows), laid out [first of every tile | second of every tile]; slots of a
    tile with fewer than 2 valid rows are (-3e38, -1)."""
    if codes.device.type == "cpu":
        return blockmax2_reference(codes, qi, mask)
    m8 = _check(codes, qi, mask)
    n, d = codes.shape
    b = qi.shape[0]
    nt = -(-n // BLOCKMAX_TILE)
    if nt > 65535:
        raise ValueError(f"{n} rows exceed the block-max grid ({65535} tiles)")
    out_s = torch.empty((b, 2 * nt), dtype=torch.float32, device=codes.device)
    out_r = torch.empty((b, 2 * nt), dtype=torch.int32, device=codes.device)
    if b == 0 or nt == 0:
        return out_s, out_r
    fn = _lib("blockmax2", "rr_blockmax2",
              [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P, _P, _P])
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = fn(codes.data_ptr(), qi.data_ptr(), _ptr(m8), n, d, b,
                 out_s.data_ptr(), out_r.data_ptr(), stream)
    _raise_on(err, "blockmax2")
    blockmax2.launches += 1
    return out_s, out_r


blockmax2.launches = 0
