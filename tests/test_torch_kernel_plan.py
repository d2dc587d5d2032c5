"""The scans' launch plan (pure Python, no card): shared memory, query block,
splits and rows per split for the (D or W, k) the presets reach, and the
wrapper's layout constants against the CUDA sources they mirror. The int8
scan and the Hamming scan share the plan (csrc/tc_scan_topk.cuh): the
Hamming scan is the same tile and epilogue over +-1 bytes of K = 32 W.

The kernel entry recomputes the shared memory from its own layout and
refuses a launch planned with another (LAYOUT_MISMATCH); this file keeps the
Python side of that agreement honest without a card.
"""

import re
from pathlib import Path

import pytest

from radiant_rag_tpu_torch.ops import cuda_kernels as ck

CSRC = Path(ck.__file__).resolve().parent.parent / "csrc"
N = 1 << 20  # the bench corpus at the engine's capacity
SMS = 132    # H100 SXM

# (D, k) of the presets' scans at the auto fused depth (dense D = 384,
# preset sketch S = 512, default sketch S = 1024)
PRESET_SHAPES = [(384, 40), (384, 160), (384, 240), (384, 360), (512, 360),
                 (1024, 40), (1024, 160), (1024, 240)]
# the Hamming scan at W = 12 (K = 384 bytes): the binary stage 1's kc at the
# auto fused depth (60 x 1.0, 4.0, 6.0) and the cap
HAMMING_SHAPES = [pytest.param(32 * 12, k, id=f"hamming-W12-k{k}") for k in (60, 240, 360, 512)]


def _constant(path: Path, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, f"{name} not found in {path.name}"
    return int(m.group(1))


def test_layout_constants_match_the_cuda_sources():
    tile = CSRC / "int8_mma_tile.cuh"
    assert _constant(tile, "BN") == ck.MMA_ROWS
    assert _constant(tile, "BK") == ck._MMA_BK
    assert _constant(tile, "STAGES") == ck._MMA_STAGES
    assert _constant(tile, "SLICE_WORDS") == ck.SIGN_SLICE_WORDS
    assert _constant(tile, "SLICE_WORDS") * 32 == ck._MMA_BK  # one K byte per sign bit
    scan = CSRC / "tc_scan_topk.cuh"
    assert _constant(scan, "QCAP") == ck._SCAN_QCAP
    assert _constant(scan, "SMEM_LIMIT") == ck.SMEM_MAX
    # both scans launch through the shared plan check and occupancy query
    for src, stem in (("int8_scan_topk.cu", "int8_scan_topk"), ("hamming.cu", "hamming")):
        text = (CSRC / src).read_text()
        assert "scan_topk_launch(" in text and "scan_ctas_per_sm(" in text
        assert f"{ck._SCAN_ENTRY[stem]}_ctas_per_sm" in text


@pytest.mark.parametrize("d,k", PRESET_SHAPES + HAMMING_SHAPES)
@pytest.mark.parametrize("ctas", [1, 2])
def test_preset_shapes_fit_and_fill_one_wave(d, k, ctas):
    plan = ck.int8_scan_plan(N, 2048, k, SMS, ctas)
    assert plan.smem <= ck.SMEM_MAX == 232_448
    assert plan.smem == ck.int8_scan_smem_bytes(plan.qb, k)  # whatever D or W
    assert plan.qb == (64 if k <= 363 else 32)
    assert plan.splits * k <= 4096
    assert plan.rows_per_split % ck.MMA_ROWS == 0
    assert plan.splits * plan.rows_per_split >= N
    # one wave: every CTA of the grid is resident at once, and not more
    # than one split short of filling the card
    qblocks = -(-2048 // plan.qb)
    assert qblocks * plan.splits <= SMS * ctas < qblocks * (plan.splits + 1)
    assert plan.rows_per_split == N // plan.splits


@pytest.mark.parametrize("k,qb", [(1, 64), (40, 64), (256, 64), (257, 64), (360, 64),
                                  (363, 64), (364, 32), (400, 32), (512, 32)])
def test_query_block_for_k(k, qb):
    """64 queries per CTA while their lists fit, 32 above k = 363."""
    assert ck.int8_scan_qb(k) == qb
    assert ck.int8_scan_smem_bytes(qb, k) <= ck.SMEM_MAX
    if qb == 32:
        assert ck.int8_scan_smem_bytes(64, k) > ck.SMEM_MAX


@pytest.mark.parametrize("n,b,k", [(5000, 1, 512), (3001, 65, 40), (70_000, 16, 40),
                                   (128, 2048, 360), (1, 3, 10), (N, 16, 160), (0, 4, 10)])
def test_small_and_ragged_plans(n, b, k):
    plan = ck.int8_scan_plan(n, b, k, SMS, 2)
    assert plan.splits >= 1 and plan.splits * k <= 4096
    assert plan.splits <= max(1, -(-n // ck.MMA_ROWS))  # no split without a tile
    assert plan.rows_per_split > 0 and plan.rows_per_split % ck.MMA_ROWS == 0
    assert plan.splits * plan.rows_per_split >= n
    assert n == 0 or (plan.splits - 1) * plan.rows_per_split < n  # the last split has rows


def test_smem_does_not_depend_on_d_and_grows_with_k():
    sizes = [ck.int8_scan_smem_bytes(64, k) for k in (40, 160, 240, 360)]
    assert sizes == sorted(sizes)
    assert sizes[1] - sizes[0] == 64 * 120 * 8  # the lists: 64 queries x k x 8 bytes


# -- blockmax2: (query blocks of 128) x splits of whole 512-row tiles ----------

def test_blockmax2_constants_match_the_cuda_source():
    src = CSRC / "blockmax2.cu"
    assert _constant(src, "QB") == ck.BLOCKMAX_QB == 128
    assert _constant(src, "BLOCKMAX_TILE") == ck.BLOCKMAX_TILE == 512
    assert "int8_mma_tile.cuh" in src.read_text() and "scan_tiles<QB>" in src.read_text()
    assert not (CSRC / "int8_tile.cuh").exists()  # the __dp4a tile is retired
    # the ring of the 128-query tile and nothing else (csrc: Tile<QB>::RING_BYTES)
    assert ck.mma_ring_bytes(128) == 3 * (256 * 64 + 128) == 49_536


@pytest.mark.parametrize("n,b", [(N, 2048), (N, 1024), (N, 3), (N, 129), (N, 255),
                                 (65_536 * 512 + 700, 3), (65_536 * 512 + 700, 2048),
                                 (1300, 5), (512, 1), (1, 1), (70_000, 33), (N + 1, 4096)])
@pytest.mark.parametrize("ctas", [1, 2])
def test_blockmax2_plan_covers_every_tile_once_in_one_wave(n, b, ctas):
    plan = ck.blockmax2_plan(n, b, SMS, ctas)
    tiles = -(-n // ck.BLOCKMAX_TILE)
    assert plan.qb == 128 and plan.smem == ck.mma_ring_bytes(128) <= ck.SMEM_MAX
    assert plan.rows_per_split % ck.BLOCKMAX_TILE == 0 and plan.rows_per_split > 0
    # every 512-row tile in exactly one split, and no split empty
    per = plan.rows_per_split // ck.BLOCKMAX_TILE
    owners = [t // per for t in range(tiles)]
    assert owners == sorted(owners) and set(owners) == set(range(plan.splits))
    assert plan.splits * plan.rows_per_split >= n > (plan.splits - 1) * plan.rows_per_split
    # at most one wave, with the smallest whole-tile splits that fit in it
    qblocks = -(-b // 128)
    slots = max(1, SMS * ctas // qblocks)
    assert plan.splits <= slots and (per == 1 or -(-tiles // (per - 1)) > slots)
    assert plan.splits <= 65_535  # grid y, whatever N


def test_blockmax2_plan_lifts_the_tile_count_cap():
    """Past 65535 tiles of 512 rows the old grid (y = tiles) could not launch;
    the plan's grid y is the split count."""
    n = 65_536 * 512 + 700
    assert -(-n // ck.BLOCKMAX_TILE) > 65_535
    plan = ck.blockmax2_plan(n, 3, SMS, 2)
    assert plan.splits == SMS * 2 and plan.splits * plan.rows_per_split >= n
