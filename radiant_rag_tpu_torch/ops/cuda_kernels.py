"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

  int8_scan_topk     csrc/int8_scan_topk.cu  <- pallas_kernels.int8_scan_topk_pallas
  blockmax2          csrc/blockmax2.cu       <- pallas_kernels.blockmax2_pallas
  hamming_scores     csrc/hamming.cu         <- pallas_kernels.hamming_scores_pallas
  hamming_scores_t   csrc/hamming.cu         <- pallas_kernels.hamming_scores_pallas_t
  hamming_scan_topk  csrc/hamming.cu         <- similarity.hamming_scan_topk's scan,
                                                 the same product with a top-k epilogue
  int8_scores        csrc/int8_scores.cu     <- pallas_kernels.int8_scores_pallas
  bm25_rescore_topk  csrc/bm25_rescore_topk.cu  <- no Pallas kernel: the BM25
                                                 sketch route's stage 2 (ops/bm25.py),
                                                 the candidates' exact BM25 and top-k

The others run on the int8 tensor-core tile (csrc/int8_mma_tile.cuh: wgmma
int8 products over 128 rows per CTA, 128 queries for the (B, N) scores and
the block-max, 64 (or 32) for the scans). The int8 kernels feed it int8 rows by
cp.async; the Hamming kernels feed it their sign words unpacked to +-1
bytes (`sign_matrix` is that operand), since <s_q, s_c> = 32 W - 2 Hamming.
The scans share one filtered top-k epilogue and launch plan
(csrc/tc_scan_topk.cuh), the score kernels one staged-store epilogue
(csrc/tc_scores.cuh); `blockmax2` keeps a per-query top-2 in registers.

A wrapper runs the plain PyTorch version only for CPU tensors. For CUDA
tensors it launches the kernel or raises; nothing falls back. Each wrapper
counts its launches in `<wrapper>.launches`, and by shape in
`launches_by_shape[(wrapper name, width D, W or L, k or 0, B)]`, so a run can show
that its path went through the kernel, and at which shapes.

The scan and block-max wrappers plan a launch in Python (`int8_scan_plan`,
`blockmax2_plan`): shared memory per CTA, to refuse a k that does not fit,
and a one-wave grid. They pass the plan to the launch, which refuses to run
if its own layout needs another.

Widths. The tile copies rows in 16-byte chunks, so where D % 16 != 0 the
int8 wrappers zero-pad codes and queries to the next multiple of 16 for the
call (the pad adds 0 to every dot). Accumulation is int32, which holds
|score| <= 128^2 * D exactly for D < 2^17 (and 32 W for W < 2^12).

The plain versions compute the same function the obvious way: the integer
dot products as a float matmul (fp32 up to D = 1024, where |score| <=
127 * 128 * D < 2^24 keeps every partial sum an exactly representable
integer; float64 above), then a top-k over unique int64 keys (score, then
row ascending) so that ties break by the lowest row exactly as the kernels
and `lax.top_k` do. The Hamming plain versions take the
popcount of `torch.bitwise_xor` by bit arithmetic on int64 (a SWAR
popcount), a block of queries and rows at a time.

Sign codes are int32 tensors holding the JAX package's uint32 bits; the
kernels read them as uint32.

`bm25_rescore_topk` is no product: one CTA per query streams its
candidates' doc-major rows through shared memory by cp.async, matches
them with the query's term ids, and sorts the candidates' (score, tie)
keys (csrc/bm25_rescore_topk.cu). Its plain version is the PyTorch form
the sketch route ran before: the candidates sorted by row (or kept in the
scan's order), `ops/bm25.bm25_candidate_rescore`, `topk_first`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from radiant_rag_tpu_torch import _build

NEG = -3.0e38  # score of an empty output slot (pallas_kernels.NEG)
BLOCKMAX_TILE = 512  # rows per block-max tile: part of the selection semantics
# Per-query list length of the scan kernels: the 32-query CTA's lists fill
# its shared memory at k = 512 (`int8_scan_smem_bytes`, `_check_k`).
INT8_SCAN_TOPK_MAX_K = 512
SMEM_MAX = 232_448  # dynamic shared memory one CTA may use on Hopper (227 KB)
_MERGE_MAX = 4096  # largest splits * k the merge launch sorts in shared memory
_REF_QUERY_CHUNK = 256  # query rows per plain-version step (bounds its (B, N) buffer)
_REF_CELLS = 1 << 25  # (query, row, word) cells per Hamming plain-version step
# the int8 tensor-core tile (csrc/int8_mma_tile.cuh): rows per tile, bytes of
# K per ring slice, ring stages; and the scans' queue entries per query
# (csrc/tc_scan_topk.cuh)
MMA_ROWS, _MMA_BK, _MMA_STAGES, _SCAN_QCAP = 128, 64, 3, 16
SIGN_SLICE_WORDS = 2  # sign words per ring slice: one K byte per bit
BLOCKMAX_QB = 128  # queries per block-max CTA (csrc/blockmax2.cu QB)
# Widths whose int32 accumulation is exact: |score| <= 128^2 * D < 2^31 for
# D < 2^17 (and the Hamming raw score |32 W| far inside it for W < 2^12)
MAX_D, MAX_W = (1 << 17) - 1, (1 << 12) - 1
_EXACT_F32_D = 1024  # widest D whose dots an fp32 matmul sums exactly
_P = ctypes.c_void_p
_LAYOUT_MISMATCH = -1  # a scan entry's return when its shared-memory layout disagrees
# the BM25 rescore (csrc/bm25_rescore_topk.cu): warps per CTA (one CTA per
# query), ring stages per warp, candidates and term slots per query, the
# key array's least length
RESCORE_WARPS, RESCORE_STAGES = 8, 3
RESCORE_MAX_KC, RESCORE_MAX_T, _RESCORE_MIN_KEYS = 4096, 128, 32
launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}


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


def _dot_operand(codes: torch.Tensor) -> torch.Tensor:
    """Transposed codes in the float type whose matmul sums their dots
    exactly: fp32 up to D = 1024, float64 above (see module doc)."""
    exact = torch.float32 if codes.shape[-1] <= _EXACT_F32_D else torch.float64
    return codes.to(exact).T


def _dots(codes_t: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Exact integer dots against `_dot_operand(codes)`."""
    return qi.to(codes_t.dtype) @ codes_t


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 element of x (values below 2^32), in place."""
    x -= (x >> 1) & 0x55555555
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _hamming(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 Hamming distances between (B, W) and (N, W) sign words,
    a block of (query, row, word) cells at a time."""
    b, (n, w) = q.shape[0], codes.shape
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    c64 = codes.to(torch.int64) & 0xFFFFFFFF
    q64 = q.to(torch.int64) & 0xFFFFFFFF
    rows = max(1, min(n, _REF_CELLS // max(w, 1)))
    qs = max(1, _REF_CELLS // (rows * max(w, 1)))
    for r0 in range(0, n, rows):
        c = c64[r0:r0 + rows]
        for q0 in range(0, b, qs):
            x = torch.bitwise_xor(q64[q0:q0 + qs, None, :], c[None, :, :])
            out[q0:q0 + qs, r0:r0 + rows] = _popcount64(x).sum(dim=2).to(torch.int32)
    return out


def _topk_rows(score_blocks, mask: Optional[torch.Tensor], n: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of exact-integer (b, N) score blocks in the kernels' order
    (score descending, row ascending; masked rows out; empty (NEG, -1))."""
    kk = min(k, n)
    outs_s, outs_r = [], []
    for scores in score_blocks:
        s, r = _decode(torch.topk(_keys(scores, mask), kk, dim=1).values)
        outs_s.append(s)
        outs_r.append(r)
    s, r = torch.cat(outs_s), torch.cat(outs_r)
    if kk < k:
        s = torch.nn.functional.pad(s, (0, k - kk), value=NEG)
        r = torch.nn.functional.pad(r, (0, k - kk), value=-1)
    return s, r


def int8_scan_topk_reference(codes: torch.Tensor, qi: torch.Tensor,
                             mask: Optional[torch.Tensor], k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `int8_scan_topk`."""
    codes_t = _dot_operand(codes)
    blocks = (_dots(codes_t, qi[q0:q0 + _REF_QUERY_CHUNK])
              for q0 in range(0, max(qi.shape[0], 1), _REF_QUERY_CHUNK))
    return _topk_rows(blocks, mask, codes.shape[0], k)


def int8_scores_reference(codes: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_scores`: (B, N) int32 raw dot products."""
    return _dots(_dot_operand(codes), qi).to(torch.int32)


def hamming_scores_reference(codes: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """Plain version of `hamming_scores`: (B, N) int32 distances from (N, W)
    codes."""
    return _hamming(codes, qcodes)


def hamming_scores_t_reference(codes_t: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """Plain version of `hamming_scores_t`: the same from (W, N) codes."""
    return _hamming(codes_t.T, qcodes)


def sign_matrix(words: torch.Tensor) -> torch.Tensor:
    """The Hamming kernels' operand: (rows, W) int32 sign words -> (rows,
    32 W) int8, K byte 32 x + j = +1 where bit j of word x is set, else -1,
    so that <s_q, s_c> = 32 W - 2 * Hamming(q, c). The tile reads K in
    slices of SIGN_SLICE_WORDS words; past 32 W it holds zero bytes."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return (2 * bits - 1).to(torch.int8).reshape(words.shape[0], -1)


def hamming_scan_topk_reference(codes: torch.Tensor, qcodes: torch.Tensor,
                                mask: Optional[torch.Tensor], k: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `hamming_scan_topk`."""
    top = 32 * codes.shape[1]
    blocks = (top - 2 * _hamming(codes, qcodes[q0:q0 + _REF_QUERY_CHUNK])
              for q0 in range(0, max(qcodes.shape[0], 1), _REF_QUERY_CHUNK))
    return _topk_rows(blocks, mask, codes.shape[0], k)


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
    codes_t = _dot_operand(codes)
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


def _check_pair(codes: torch.Tensor, q: torch.Tensor, dtype: torch.dtype, n: int, width: int,
                width_ok: bool, what: str) -> None:
    if codes.dtype != dtype or q.dtype != dtype:
        raise TypeError(f"{dtype} codes and queries expected, got {codes.dtype}, {q.dtype}")
    if codes.dim() != 2 or q.dim() != 2 or width != q.shape[1]:
        raise ValueError(f"shapes {tuple(codes.shape)} and {tuple(q.shape)} do not match")
    if not (codes.is_contiguous() and q.is_contiguous()):
        raise ValueError("codes and queries must be contiguous")
    if q.device != codes.device:
        raise ValueError("codes and queries must be on one device")
    if not width_ok:
        raise ValueError(f"the kernels take {what}, got {width}")
    if n >= 2**31 - 1:
        raise ValueError(f"{n} rows exceed the kernels' int32 row ids")


def _check_mask(mask: Optional[torch.Tensor], n: int, device: torch.device):
    if mask is None:
        return None
    if mask.shape != (n,) or mask.device != device:
        raise ValueError(f"mask of shape {tuple(mask.shape)} does not match {n} rows")
    if mask.dtype not in (torch.bool, torch.uint8, torch.int8):
        raise TypeError(f"bool / uint8 mask expected, got {mask.dtype}")
    return mask.contiguous().view(torch.uint8)


def _check(codes: torch.Tensor, qi: torch.Tensor, mask: Optional[torch.Tensor]):
    """int8 (N, D) codes and (B, D) queries; returns the mask as uint8."""
    d = codes.shape[-1]
    _check_pair(codes, qi, torch.int8, codes.shape[0], d, 0 < d <= MAX_D,
                f"0 < D <= {MAX_D} (exact int32 accumulation)")
    return _check_mask(mask, codes.shape[0], codes.device)


def _check_words(codes: torch.Tensor, q: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 transposed: bool = False):
    """int32 sign words, (N, W) or transposed (W, N), and (B, W) queries;
    returns the mask as uint8."""
    w, n = (codes.shape[0], codes.shape[-1]) if transposed else (codes.shape[-1], codes.shape[0])
    _check_pair(codes, q, torch.int32, n, w, 0 < w <= MAX_W, f"0 < W <= {MAX_W} words")
    return _check_mask(mask, n, codes.device)


def padded_width(d: int) -> int:
    """D as the tile reads it: rows are copied in 16-byte chunks."""
    return -(-d // 16) * 16


def _pad16(codes: torch.Tensor, qi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes and queries zero-padded to `padded_width(D)` columns where D %
    16 != 0 (a zero column adds 0 to every dot), else as they are. The copy
    moves N x D16 bytes at most: ~0.2 ms at 1M x 304 on an H100 (3.35
    TB/s), against ~8 ms for a scan of the same rows."""
    pad = padded_width(codes.shape[1]) - codes.shape[1]
    if not pad:
        return codes, qi
    return (torch.nn.functional.pad(codes, (0, pad)), torch.nn.functional.pad(qi, (0, pad)))


def mma_ring_bytes(qb: int) -> int:
    """Shared memory of the tensor-core tile's ring at `qb` queries: 3 stages
    of qb + 128 rows x 64 bytes, and 128 mask bytes each."""
    return _MMA_STAGES * ((qb + MMA_ROWS) * _MMA_BK + MMA_ROWS)


def int8_scan_smem_bytes(qb: int, k: int) -> int:
    """Shared memory of one int8 scan CTA of `qb` queries: the ring, the k-th
    score, k-th row and queue count per query, the 16-entry queues and the
    lists (qb x k), (score, row) int32 pairs each."""
    return mma_ring_bytes(qb) + qb * 4 * 3 + qb * _SCAN_QCAP * 8 + qb * k * 8


def int8_scan_qb(k: int) -> int:
    """Queries per int8 scan CTA at list length k: 64 where the lists fit in
    one CTA's shared memory, else 32 (csrc/int8_scan_topk.cu scan_qb)."""
    return 64 if int8_scan_smem_bytes(64, k) <= SMEM_MAX else 32


class ScanPlan(NamedTuple):
    qb: int              # queries per CTA
    smem: int            # shared memory per CTA
    splits: int          # corpus splits (grid y)
    rows_per_split: int  # a multiple of the kernel's row unit


def _one_wave(units: int, slots: int) -> Tuple[int, int]:
    """(splits, units per split): at most `slots` splits (at least 1), each
    a whole number of units, none of them empty."""
    splits = max(1, min(slots, units))
    per_split = max(1, -(-units // splits))
    return max(1, -(-units // per_split)), per_split


def int8_scan_plan(n: int, b: int, k: int, num_sms: int, ctas_per_sm: int) -> ScanPlan:
    """Launch plan of `int8_scan_topk`: as many splits as let the (query
    blocks x splits) grid fill one wave of `num_sms` x `ctas_per_sm` CTAs
    without starting a second (at least 1), no more splits than 128-row
    tiles, none of them empty, and splits x k within the merge's sort."""
    qb = int8_scan_qb(k)
    qblocks = max(1, -(-b // qb))
    slots = min(num_sms * max(ctas_per_sm, 1) // qblocks, _MERGE_MAX // k)
    splits, per_split = _one_wave(-(-n // MMA_ROWS), slots)
    return ScanPlan(qb, int8_scan_smem_bytes(qb, k), splits, per_split * MMA_ROWS)


def blockmax2_plan(n: int, b: int, num_sms: int, ctas_per_sm: int) -> ScanPlan:
    """Launch plan of `blockmax2`: (query blocks of 128) x splits filling
    one wave of `num_sms` x `ctas_per_sm` CTAs (at least 1 split), each
    split a whole number of 512-row tiles (a tile's top-2 never spans two
    CTAs), none empty. No grid dimension grows with N."""
    qblocks = max(1, -(-b // BLOCKMAX_QB))
    splits, per_split = _one_wave(-(-n // BLOCKMAX_TILE), num_sms * max(ctas_per_sm, 1) // qblocks)
    return ScanPlan(BLOCKMAX_QB, mma_ring_bytes(BLOCKMAX_QB), splits, per_split * BLOCKMAX_TILE)


def _check_k(k: int, smem: int, what: str) -> None:
    if not 1 <= k <= INT8_SCAN_TOPK_MAX_K:
        raise ValueError(f"k={k} outside the kernel's 1..{INT8_SCAN_TOPK_MAX_K}")
    if smem > SMEM_MAX:
        raise ValueError(f"k={k} at {what} needs {smem} bytes of shared memory per CTA "
                         f"(tile + queries x k x 8 bytes of lists) > {SMEM_MAX}")


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The int8 tiles copy 16-byte chunks (cp.async, int4 loads)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("int8 codes and queries must start on a 16-byte boundary")


def _lib(stem: str, entry: str, argtypes):
    fn = getattr(_build.library(stem), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str) -> None:
    if err == _LAYOUT_MISMATCH:
        raise RuntimeError(f"{name}: the kernel's shared-memory layout or row tile differs "
                           "from the wrapper's launch plan (ops/cuda_kernels.py)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


_SCAN_ENTRY = {"int8_scan_topk": "rr_int8_scan_topk", "hamming": "rr_hamming_scan_topk"}
_ctas_per_sm: Dict[Tuple[str, int, int], int] = {}


def _occupancy(key: Tuple[str, int, int], stem: str, entry: str, dev: torch.device,
               *args) -> int:
    """CTAs one SM of `dev` holds of a kernel of csrc/<stem>.cu, from the
    occupancy API over the built kernel (its registers and shared memory),
    cached under `key`."""
    if key not in _ctas_per_sm:
        fn = _lib(stem, entry, [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _raise_on(fn(*args, ctypes.byref(out)), entry)
        _ctas_per_sm[key] = out.value
    return _ctas_per_sm[key]


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def int8_scan_ctas_per_sm(stem: str, k: int, dev: torch.device) -> int:
    """Partial CTAs one SM of `dev` holds at list length k for the scan of
    csrc/<stem>.cu (`int8_scan_topk` or `hamming`)."""
    return _occupancy((stem, _dev_index(dev), k), stem, f"{_SCAN_ENTRY[stem]}_ctas_per_sm", dev,
                      k)


def blockmax2_ctas_per_sm(dev: torch.device) -> int:
    """Block-max CTAs one SM of `dev` holds."""
    return _occupancy(("blockmax2", _dev_index(dev), 0), "blockmax2", "rr_blockmax2_ctas_per_sm",
                      dev)


def _scan_plan(stem: str, n: int, b: int, k: int, dev: torch.device) -> ScanPlan:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return int8_scan_plan(n, b, k, sms, int8_scan_ctas_per_sm(stem, k, dev))


def _aligned_mask(m8: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The tile copies mask bytes 16 at a time: a misaligned mask is copied."""
    return m8.clone() if m8 is not None and m8.data_ptr() % 16 else m8


def _count(fn, width: int, k: int, b: int) -> None:
    """One launch of `fn`'s kernel at width D or W, depth k (0 for a kernel
    that selects none) and b queries."""
    fn.launches += 1
    key = (fn.__name__, width, k, b)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


def _scan_topk(stem: str, codes: torch.Tensor, q: torch.Tensor,
               m8: Optional[torch.Tensor], n: int, width: int, k: int, plan: ScanPlan
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the split scan -> top-k kernel of csrc/<stem>.cu (partial
    lists, then the merge) on `plan`."""
    b = q.shape[0]
    dev = codes.device
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_r
    splits = plan.splits
    merge_p = 1 << max(0, (splits * k - 1).bit_length())
    part_s = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    part_r = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    entry = _SCAN_ENTRY[stem]
    fn = _lib(stem, entry,
              [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(codes.data_ptr(), q.data_ptr(), _ptr(m8), n, width, b, k, splits,
                 plan.rows_per_split, merge_p, plan.smem, part_s.data_ptr(), part_r.data_ptr(),
                 out_s.data_ptr(), out_r.data_ptr(), _stream(dev))
    _raise_on(err, entry)
    return out_s, out_r


def _scores(stem: str, entry: str, codes: torch.Tensor, q: torch.Tensor, n: int, width: int
            ) -> torch.Tensor:
    """Launch a (B, N) int32 score kernel."""
    b = q.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    if b == 0 or n == 0:
        return out
    fn = _lib(stem, entry, [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P, _P])
    with torch.cuda.device(codes.device):
        err = fn(codes.data_ptr(), q.data_ptr(), n, width, b, out.data_ptr(),
                 _stream(codes.device))
    _raise_on(err, entry)
    return out


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
    n, d = codes.shape
    _check_k(k, int8_scan_smem_bytes(int8_scan_qb(k), k), f"D={d}")
    codes, qi = _pad16(codes, qi)
    _check_aligned(codes, qi)
    plan = _scan_plan("int8_scan_topk", n, qi.shape[0], k, codes.device)
    out = _scan_topk("int8_scan_topk", codes, qi, _aligned_mask(m8), n, codes.shape[1],
                     k, plan)
    _count(int8_scan_topk, d, k, qi.shape[0])
    return out


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
    out_s = torch.empty((b, 2 * nt), dtype=torch.float32, device=codes.device)
    out_r = torch.empty((b, 2 * nt), dtype=torch.int32, device=codes.device)
    if b == 0 or nt == 0:
        return out_s, out_r
    codes, qi = _pad16(codes, qi)
    _check_aligned(codes, qi)
    dev = codes.device
    plan = blockmax2_plan(n, b, torch.cuda.get_device_properties(dev).multi_processor_count,
                          blockmax2_ctas_per_sm(dev))
    fn = _lib("blockmax2", "rr_blockmax2",
              [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int64, ctypes.c_int64, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(codes.data_ptr(), qi.data_ptr(), _ptr(_aligned_mask(m8)), n, codes.shape[1], b,
                 plan.splits, plan.rows_per_split, plan.smem, out_s.data_ptr(), out_r.data_ptr(),
                 _stream(dev))
    _raise_on(err, "blockmax2")
    _count(blockmax2, d, 0, b)
    return out_s, out_r


blockmax2.launches = 0


def int8_scores(codes: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 raw dot products qi . codes^T of (N, D) int8 codes and
    (B, D) int8 queries, every row scored."""
    if codes.device.type == "cpu":
        return int8_scores_reference(codes, qi)
    _check(codes, qi, None)
    n, d = codes.shape
    codes, qi = _pad16(codes, qi)
    _check_aligned(codes, qi)
    out = _scores("int8_scores", "rr_int8_scores", codes, qi, n, codes.shape[1])
    _count(int8_scores, d, 0, qi.shape[0])
    return out


int8_scores.launches = 0


def hamming_scores(codes: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 Hamming distances of (B, W) query words to (N, W) code
    words (int32 tensors holding the uint32 sign bits)."""
    if codes.device.type == "cpu":
        return hamming_scores_reference(codes, qcodes)
    _check_words(codes, qcodes)
    n, w = codes.shape
    out = _scores("hamming", "rr_hamming_scores", codes, qcodes, n, w)
    _count(hamming_scores, w, 0, qcodes.shape[0])
    return out


hamming_scores.launches = 0


def hamming_scores_t(codes_t: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """`hamming_scores` from transposed (W, N) code words."""
    if codes_t.device.type == "cpu":
        return hamming_scores_t_reference(codes_t, qcodes)
    _check_words(codes_t, qcodes, transposed=True)
    w, n = codes_t.shape
    out = _scores("hamming", "rr_hamming_scores_t", codes_t, qcodes, n, w)
    _count(hamming_scores_t, w, 0, qcodes.shape[0])
    return out


hamming_scores_t.launches = 0


def hamming_scan_topk(codes: torch.Tensor, qcodes: torch.Tensor,
                      mask: Optional[torch.Tensor], k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of raw = 32 W - 2 * Hamming distance per query, without a
    (B, N) matrix: ((B, k) f32 raw, (B, k) int32 rows), ordered raw
    descending then row ascending; masked rows excluded; empty slots
    (-3e38, -1)."""
    if codes.device.type == "cpu":
        return hamming_scan_topk_reference(codes, qcodes, mask, k)
    m8 = _check_words(codes, qcodes, mask)
    n, w = codes.shape
    _check_k(k, int8_scan_smem_bytes(int8_scan_qb(k), k), f"W={w}")
    plan = _scan_plan("hamming", n, qcodes.shape[0], k, codes.device)
    out = _scan_topk("hamming", codes, qcodes, _aligned_mask(m8), n, w,
                     k, plan)
    _count(hamming_scan_topk, w, k, qcodes.shape[0])
    return out


hamming_scan_topk.launches = 0


def bm25_rescore_topk_reference(doc_tids: torch.Tensor, doc_tfs: torch.Tensor,
                                doc_lens: torch.Tensor, avgdl: torch.Tensor, cand: torch.Tensor,
                                q_tids: torch.Tensor, q_idfs: torch.Tensor, k: int,
                                k1: float = 1.5, b: float = 0.75, row_ties: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bm25_rescore_topk`."""
    # imported here: ops.bm25 and ops.similarity import this module
    from radiant_rag_tpu_torch.ops import bm25, similarity

    if row_ties:
        cand = similarity.sort_candidates_by_row(cand)
    exact = bm25.bm25_candidate_rescore(doc_tids, doc_tfs, doc_lens, avgdl, cand, q_tids,
                                        q_idfs, k1, b)
    top_s, sel = similarity.topk_first(exact, k)
    return top_s, torch.where(top_s > 0.0, cand.gather(1, sel), -1).to(torch.int32)


def bm25_rescore_smem_bytes(width: int, kc: int) -> int:
    """Shared memory of one rescore CTA: the (score, tie) keys (KC padded to
    a power of two, at least 32), each warp's ring of (L tids, L tfs, the
    doc length) stages of 16-byte multiples, the KC candidate rows."""
    keys = max(_RESCORE_MIN_KEYS, 1 << max(0, (kc - 1).bit_length()))
    stage = -(-(8 * width + 4) // 16) * 16
    return keys * 8 + RESCORE_WARPS * RESCORE_STAGES * stage + -(-(4 * kc) // 16) * 16


def bm25_rescore_check(width: int, kc: int, t: int, k: int) -> int:
    """Raise on a shape the rescore kernel cannot take; else its shared
    memory per CTA."""
    if width % 4:
        raise ValueError(f"L={width}: the kernel copies the term rows 16 bytes at a time, "
                         "so L must be a multiple of 4")
    if not 1 <= kc <= RESCORE_MAX_KC:
        raise ValueError(f"KC={kc} candidates outside the kernel's 1..{RESCORE_MAX_KC}")
    if not 1 <= k <= kc:
        raise ValueError(f"k={k} outside the kernel's 1..KC={kc}")
    if not 0 <= t <= RESCORE_MAX_T:
        raise ValueError(f"T={t} query terms outside the kernel's 0..{RESCORE_MAX_T}")
    smem = bm25_rescore_smem_bytes(width, kc)
    if smem > SMEM_MAX:
        raise ValueError(f"L={width}, KC={kc} need {smem} bytes of shared memory per CTA "
                         f"(keys + {RESCORE_WARPS} warps x {RESCORE_STAGES} rows of L x 8 "
                         f"bytes) > {SMEM_MAX}")
    return smem


def _check_rescore(doc_tids, doc_tfs, doc_lens, avgdl, cand, q_tids, q_idfs) -> None:
    ints, floats = (doc_tids, doc_tfs, cand, q_tids), (doc_lens, avgdl, q_idfs)
    if any(x.dtype != torch.int32 for x in ints) or any(x.dtype != torch.float32
                                                        for x in floats):
        raise TypeError("int32 term tables, candidates and query terms and float32 lengths, "
                        "avgdl and idfs expected")
    if any(x.device != cand.device for x in ints + floats):
        raise ValueError("the rescore's tensors must be on one device")
    if (doc_tids.dim() != 2 or doc_tfs.shape != doc_tids.shape or cand.dim() != 2
            or q_tids.dim() != 2 or q_idfs.shape != q_tids.shape
            or q_tids.shape[0] != cand.shape[0] or doc_lens.dim() != 1
            or doc_lens.shape[0] < doc_tids.shape[0] or avgdl.numel() != 1):
        raise ValueError(f"shapes do not match: tables {tuple(doc_tids.shape)} / "
                         f"{tuple(doc_tfs.shape)}, lengths {tuple(doc_lens.shape)}, candidates "
                         f"{tuple(cand.shape)}, terms {tuple(q_tids.shape)} / "
                         f"{tuple(q_idfs.shape)}")
    if not (doc_tids.is_contiguous() and doc_tfs.is_contiguous() and doc_lens.is_contiguous()):
        raise ValueError("the term tables and lengths must be contiguous")
    if doc_tids.data_ptr() % 16 or doc_tfs.data_ptr() % 16:
        raise ValueError("the term tables must start on a 16-byte boundary")


def bm25_rescore_topk(doc_tids: torch.Tensor, doc_tfs: torch.Tensor, doc_lens: torch.Tensor,
                      avgdl: torch.Tensor, cand: torch.Tensor, q_tids: torch.Tensor,
                      q_idfs: torch.Tensor, k: int, k1: float = 1.5, b: float = 0.75,
                      row_ties: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 of (B, KC) candidate rows and its top-k per query.

    doc_tids / doc_tfs (N, L) int32 doc-major term ids (-1 = empty slot) and
    tfs, doc_lens (>= N,) f32, avgdl one f32, cand (B, KC) int32 rows (-1 =
    pad), q_tids (B, T) int32 (-1 = empty) and q_idfs (B, T) f32. Returns
    ((B, k) f32 scores, (B, k) int32 rows, -1 where the score is not > 0),
    ordered score descending, then row ascending (`row_ties`) or candidate
    position ascending (the order `cand` holds). Pads score NEG_INF."""
    if cand.device.type == "cpu":
        return bm25_rescore_topk_reference(doc_tids, doc_tfs, doc_lens, avgdl, cand, q_tids,
                                           q_idfs, k, k1, b, row_ties)
    _check_rescore(doc_tids, doc_tfs, doc_lens, avgdl, cand, q_tids, q_idfs)
    (bq, kc), (n, width), t = cand.shape, doc_tids.shape, q_tids.shape[1]
    dev = cand.device
    out_s = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((bq, k), dtype=torch.int32, device=dev)
    if bq == 0 or k == 0:
        return out_s, out_r
    smem = bm25_rescore_check(width, kc, t, k)
    if n >= 2**31 - 1:
        raise ValueError(f"{n} rows exceed the kernel's int32 row ids")
    cand, q_tids, q_idfs = cand.contiguous(), q_tids.contiguous(), q_idfs.contiguous()
    f = ctypes.c_float
    fn = _lib("bm25_rescore_topk", "rr_bm25_rescore_topk",
              [_P] * 7 + [ctypes.c_int] * 5 + [f] * 4 + [ctypes.c_int, ctypes.c_int64]
              + [_P] * 3)
    with torch.cuda.device(dev):
        err = fn(doc_tids.data_ptr(), doc_tfs.data_ptr(), doc_lens.data_ptr(), avgdl.data_ptr(),
                 cand.data_ptr(), q_tids.data_ptr(), q_idfs.data_ptr(), bq, kc, width, t, k,
                 f(k1), f(b), f(1.0 - b), f(k1 + 1.0), int(row_ties), smem,
                 out_s.data_ptr(), out_r.data_ptr(), _stream(dev))
    _raise_on(err, "bm25_rescore_topk")
    _count(bm25_rescore_topk, width, k, bq)
    return out_s, out_r


bm25_rescore_topk.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0, by shape too."""
    for fn in KERNELS:
        fn.launches = 0
    launches_by_shape.clear()


KERNELS = (int8_scan_topk, blockmax2, hamming_scan_topk, hamming_scores, hamming_scores_t,
           int8_scores, bm25_rescore_topk)
