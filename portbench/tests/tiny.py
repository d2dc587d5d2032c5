"""A cell cut to a size the CPU runs in seconds: 3,000 passages, a 2-layer
64-wide encoder, small batches, every request kept for the check (so a
slow CPU that finishes few requests in the window still has some to
judge). Only the tests use it."""

from __future__ import annotations

import time

import torch

from pbcore import cell

SEED = 2**31 + 12345


def overrides(name: str):
    enc = {"dim": 64, "num_layers": 2, "num_heads": 4, "hidden_dim": 128}
    return {"config": {"num_passages": 3000, "dim": 64, "hidden_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 4,
                       "intermediate_size": 128, "ingest_batch": 1024,
                       "program_config": {"embedding": enc, "cross_encoder": enc,
                                          "index": {"dim": 64}}},
            "traffic": {"batch_size": 8 if "rerank" in name else 64, "max_batches_per_s": 4,
                        "judged_queries": 16, "kept_requests": 64, "judged_requests": 2}}


def run(name: str, seed: int = SEED, traced: bool = False, fault=None, control=False):
    return cell.run_cell(name, seed, 1.0, traced, torch.device("cpu"), time.perf_counter(),
                         overrides=overrides(name), fault=fault, control=control)
