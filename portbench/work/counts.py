"""Work a request needs, counted from shapes and the algorithm, and the least
time the chip needs for it at the published peaks (`peaks.json`).

The same counts hold whatever kernel does the work:

  scans     int8 or +-1-int8 operations 2 B N D (the Hamming scan as the
            +-1 product of its sign bits, D = 32 W); bytes each input read
            once and each output written once: codes N D (N 4 W), queries,
            the row mask N, candidates B k x 8 (chip_smoke.py's `bound`)
  encoders  bfloat16 FLOPs over each sequence's real tokens L:
            layers x (2 L (4 h^2 + 2 h ff) + 4 L^2 h), and the cross-encoder's
            pooler and classifier 2 (h^2 + h)
  rescore   the dense candidates' gather (kc D x 4 bytes, or kc D int8
            codes) and 2 kc D float32 FLOPs per query
  stages    each of the traffic's stages counts its own (its `work`)
  not counted: the BM25 exact rescore, the fusion, the rerank blend, host
            work (PERF.md lists them)

Each item is (name, operations, bytes, peak key); its least time is the
larger of operations over its peak and bytes over the memory rate.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

Item = Tuple[str, float, float, str]


def least_seconds(items: List[Item]) -> float:
    bw = PEAKS["hbm_bytes_per_s"]
    return sum(max(ops / PEAKS[peak], moved / bw) for _, ops, moved, peak in items)


def scan(name: str, b: int, n: int, d: int, k: int, code_bytes_per_row: int) -> Item:
    moved = n * code_bytes_per_row + b * code_bytes_per_row + n + b * k * 8
    return (name, 2.0 * b * n * d, float(moved), "int8_ops_per_s")


def encoder_flops(model: Dict, lengths: List[int]) -> float:
    h, ff = int(model["hidden_size"]), int(model["intermediate_size"])
    layers = int(model["num_hidden_layers"])
    return float(sum(layers * (2 * L * (4 * h * h + 2 * h * ff) + 4 * L * L * h)
                     for L in lengths))


def plan(config: Dict, traffic: Dict) -> Dict:
    """The legs' depths as the configuration sets them: the fused pool
    (retrieval.fused_depth, -1 = 4 x fused_top_k) deepens both legs past
    the request's top_k, and stage 1 keeps round(depth x
    rescore_multiplier) candidates."""
    pc = config["program_config"]
    r, q = pc["retrieval"], pc["quantization"]
    fd = int(r["fused_depth"])
    fd = 4 * int(r["fused_top_k"]) if fd < 0 else fd
    k = int(traffic["top_k"])
    depth = max(k, min(fd, int(config["num_passages"])))
    kc = max(depth, int(round(depth * float(q["rescore_multiplier"]))))
    return {"depth": depth, "candidates": kc, "sketch_dim": int(pc["bm25"]["sketch_dim"]),
            "dense_stage1": "binary" if q["precision"] == "binary" else "int8",
            "store_fp32": bool(pc["index"]["store_fp32"])}


def per_request(config: Dict, traffic: Dict, stages: Sequence = ()) -> Dict[str, List[Item]]:
    """Work items of one request, grouped by the stage that does them
    ("scan_int8", "scan_binary", "encoder", "cross_encoder", "rescore"),
    with each of `stages`' own (the modules of the traffic's stages)."""
    cfg, p = config, plan(config, traffic)
    b = int(traffic["batch_size"])
    n = int(cfg["num_passages"])
    d = int(cfg["dim"])
    kc = bkc = p["candidates"]
    s = p["sketch_dim"]
    out: Dict[str, List[Item]] = {"scan_int8": [], "scan_binary": [], "encoder": [],
                                  "cross_encoder": [], "rescore": []}
    if p["dense_stage1"] == "binary":
        w = (d + 31) // 32
        out["scan_binary"].append(scan("hamming scan", b, n, 32 * w, kc, 4 * w))
    else:
        out["scan_int8"].append(scan("int8 scan", b, n, d, kc, d))
    rescore_bytes = kc * d * 4 if p["store_fp32"] else kc * d  # else int8, dequantised
    sketch = scan("sketch scan", b, n, s, bkc, s)
    out["scan_binary" if p["dense_stage1"] == "binary" else "scan_int8"].append(sketch)
    out["rescore"].append(("dense rescore", 2.0 * b * kc * d, float(b * rescore_bytes),
                           "fp32_flops_per_s"))
    if traffic["query_form"] == "text":
        qlen = int(traffic["query_words"]) + 2  # [CLS] words [SEP]
        out["encoder"].append(("query encoder", encoder_flops(cfg, [qlen] * b), 0.0,
                               "bf16_flops_per_s"))
    rr = traffic.get("rerank")
    if rr:
        h = int(cfg["hidden_size"])
        q = min(int(traffic["query_words"]), int(rr["q_len"]))
        dl = min(int(cfg["words_per_doc"]), int(rr["d_len"]))
        pairs = b * int(traffic["top_k"])
        flops = encoder_flops(cfg, [q + dl + 3] * pairs) + pairs * 2.0 * (h * h + h)
        out["cross_encoder"].append(("cross-encoder", flops, 0.0, "bf16_flops_per_s"))
    for st in stages:
        for name, items in st.work(config, traffic).items():
            out.setdefault(name, []).extend(items)
    return out
