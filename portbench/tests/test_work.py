"""The work counts against values worked out by hand at small shapes."""

import pytest

from work import counts

PEAKS = counts.PEAKS


def config(precision="both", mult=4.0, fp32=True, sketch=64):
    return {"num_passages": 1000, "dim": 64, "words_per_doc": 10, "hidden_size": 8,
            "intermediate_size": 16, "num_hidden_layers": 2,
            "program_config": {"retrieval": {"fused_depth": -1, "fused_top_k": 5},
                               "quantization": {"precision": precision, "rescore_multiplier": mult},
                               "bm25": {"sketch_dim": sketch}, "index": {"store_fp32": fp32}}}


def traffic(form="text", rerank=None, top_k=4):
    t = {"batch_size": 16, "top_k": top_k, "query_form": form, "query_words": 3}
    if rerank:
        t["rerank"] = {"q_len": 2, "d_len": 6}
    return t


def test_plan_depths():
    p = counts.plan(config(), traffic())
    assert p == {"depth": 20, "candidates": 80, "sketch_dim": 64, "dense_stage1": "int8",
                 "store_fp32": True}
    assert counts.plan(config("binary", 6.0, False), traffic(top_k=30))["candidates"] == 180


def test_int8_scan_and_rescore():
    w = counts.per_request(config(), traffic())
    (name, ops, moved, peak), sketch = w["scan_int8"]
    assert ops == 2 * 16 * 1000 * 64 and moved == 1000 * 64 + 16 * 64 + 1000 + 16 * 80 * 8
    assert sketch[1] == 2 * 16 * 1000 * 64 and peak == "int8_ops_per_s"
    (_, fl, by, pk), = w["rescore"]
    assert fl == 2 * 16 * 80 * 64 and by == 16 * 80 * 64 * 4 and pk == "fp32_flops_per_s"


def test_binary_scan_counts_sign_bits():
    w = counts.per_request(config("binary", 6.0, False), traffic("vector"))
    (_, ops, moved, _), = [i for i in w["scan_binary"] if i[0] == "hamming scan"]
    assert ops == 2 * 16 * 1000 * 64 and moved == 1000 * 8 + 16 * 8 + 1000 + 16 * 120 * 8
    assert w["rescore"][0][2] == 16 * 120 * 64  # int8 codes, no fp32 vectors
    assert not w["encoder"]


def test_encoder_flops_over_real_tokens():
    # 2 layers, h 8, ff 16, L 5: per layer 2 L (4 h^2 + 2 h ff) + 4 L^2 h
    per_seq = 2 * (2 * 5 * (4 * 64 + 2 * 8 * 16) + 4 * 25 * 8)
    w = counts.per_request(config(), traffic())
    assert w["encoder"][0][1] == 16 * per_seq


def test_cross_encoder_flops():
    w = counts.per_request(config(), traffic(rerank=True))
    L = 2 + 6 + 3  # q_len, d_len caps, three specials
    per_pair = 2 * (2 * L * (4 * 64 + 2 * 8 * 16) + 4 * L * L * 8) + 2 * (64 + 8)
    assert w["cross_encoder"][0][1] == 16 * 4 * per_pair


def test_least_seconds():
    items = [("a", PEAKS["int8_ops_per_s"], 0.0, "int8_ops_per_s"),
             ("b", 0.0, PEAKS["hbm_bytes_per_s"] * 2, "int8_ops_per_s")]
    assert counts.least_seconds(items) == pytest.approx(3.0)
