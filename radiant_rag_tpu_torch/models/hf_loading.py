"""Pretrained HuggingFace BERT weights from a local directory.

Counterpart of `radiant_rag_tpu/models/hf_loading.py`: reads
`model.safetensors` or `pytorch_model.bin` from `embedding.weights_path` /
`cross_encoder.weights_path` (local directories only, nothing is
downloaded) and maps the HF `bert.*` names onto the port's modules, whose
names are the flax tree's. HF Linear weights are already (out, in), the
port's layout.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from radiant_rag_tpu_torch.models.bert import BertConfig

logger = logging.getLogger(__name__)


def _load_state_dict(model_dir: str) -> Optional[Dict[str, np.ndarray]]:
    d = Path(model_dir)
    st = d / "model.safetensors"
    if st.is_file():
        try:
            from safetensors.numpy import load_file

            return dict(load_file(str(st)))
        except (ImportError, OSError, ValueError) as exc:
            logger.warning("safetensors load failed: %s", exc)
    pt = d / "pytorch_model.bin"
    if pt.is_file():
        try:
            sd = torch.load(str(pt), map_location="cpu", weights_only=True)
            return {k: v.numpy() for k, v in sd.items()}
        except (OSError, RuntimeError) as exc:
            logger.warning("torch load failed: %s", exc)
    return None


def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if any(k.startswith("bert.") for k in sd):
        return {k[len("bert."):] if k.startswith("bert.") else k: v for k, v in sd.items()}
    return sd


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _bert_state(sd: Dict[str, np.ndarray], cfg: BertConfig, prefix: str = ""
                ) -> Dict[str, torch.Tensor]:
    """HF bert state dict -> the port's BertEncoder names (under `prefix`)."""
    names = {
        "word_emb.weight": "embeddings.word_embeddings.weight",
        "pos_emb.weight": "embeddings.position_embeddings.weight",
        "type_emb.weight": "embeddings.token_type_embeddings.weight",
        "emb_ln.weight": "embeddings.LayerNorm.weight",
        "emb_ln.bias": "embeddings.LayerNorm.bias",
    }
    per_layer = {
        "attention.query": "attention.self.query", "attention.key": "attention.self.key",
        "attention.value": "attention.self.value", "attention.out": "attention.output.dense",
        "attn_ln": "attention.output.LayerNorm", "mlp_in": "intermediate.dense",
        "mlp_out": "output.dense", "mlp_ln": "output.LayerNorm",
    }
    for i in range(cfg.num_layers):
        for ours, theirs in per_layer.items():
            for leaf in ("weight", "bias"):
                names[f"layer_{i}.{ours}.{leaf}"] = f"encoder.layer.{i}.{theirs}.{leaf}"
    return {prefix + ours: _tensor(sd[theirs]) for ours, theirs in names.items()}


def try_load_bert_params(model_dir: str, cfg: BertConfig) -> Optional[Dict[str, torch.Tensor]]:
    sd = _load_state_dict(model_dir)
    if sd is None:
        logger.info("no local weights at %s; using the next source", model_dir)
        return None
    try:
        return _bert_state(_strip_prefix(sd), cfg)
    except KeyError as exc:
        logger.warning("weight mapping failed (missing %s); using the next source", exc)
        return None


def try_load_cross_encoder_params(model_dir: str, cfg: BertConfig
                                  ) -> Optional[Dict[str, torch.Tensor]]:
    sd = _load_state_dict(model_dir)
    if sd is None:
        return None
    try:
        bert_sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
        out = _bert_state(bert_sd, cfg, prefix="bert.")
        for ours, src, theirs in (("pooler", bert_sd, "pooler.dense"),
                                  ("classifier", sd, "classifier")):
            for leaf in ("weight", "bias"):
                out[f"{ours}.{leaf}"] = _tensor(src[f"{theirs}.{leaf}"])
        return out
    except KeyError as exc:
        logger.warning("cross-encoder weight mapping failed (missing %s)", exc)
        return None
