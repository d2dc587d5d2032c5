"""Shipped pretrained weights: the out-of-the-box bi-encoder and reranker.

Counterpart of `radiant_rag_tpu/models/pretrained.py`. The JAX package ships
params-only npz artifacts of the checkpoints its own training recipe
produced (`radiant_rag_tpu/data/{embedder,cross_encoder}_128x6.npz`: dim
128, 6 layers, float32, keys are flax tree paths joined by '/'). The port
reads the same files by path (nothing of the JAX package is imported) and
carries them across with `convert.params_from_flat`.

Resolution order, as in the JAX package: explicit params > checkpoint_dir
> weights_path (HF) > shipped artifact (shape-matched) > seeded init.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from radiant_rag_tpu_torch.convert import params_from_flat

logger = logging.getLogger(__name__)

PRETRAINED_DIR = Path(__file__).resolve().parent.parent.parent / "radiant_rag_tpu" / "data"


def load_params_npz(path: str, template: Mapping[str, torch.Tensor]
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The port's state_dict from an npz of flax leaves, shaped like
    `template` (a module's state_dict); None when the file is absent or
    unreadable, or any leaf is missing or of another shape."""
    p = Path(path)
    if not p.is_file():
        return None
    try:
        with np.load(p) as z:
            stored = {k[len("params/"):] if k.startswith("params/") else k: z[k]
                      for k in z.files}
    except (OSError, ValueError) as exc:
        logger.warning("pretrained artifact %s unreadable (%s)", path, exc)
        return None
    try:
        params = params_from_flat(stored)
    except KeyError as exc:  # a leaf kind the port's modules do not have
        logger.info("pretrained artifact %s holds a foreign leaf (%s); ignoring", path, exc)
        return None
    for key, leaf in template.items():
        got = params.get(key)
        if got is None or tuple(got.shape) != tuple(leaf.shape):
            logger.info("pretrained artifact %s does not match the configured "
                        "architecture (leaf %s); ignoring", path, key)
            return None
    return {key: params[key] for key in template}


def _artifact(name: str, cfg) -> str:
    return str(PRETRAINED_DIR / f"{name}_{cfg.hidden_size}x{cfg.num_layers}.npz")


def shipped_embedder_params(bert_cfg, template: Mapping[str, torch.Tensor]
                            ) -> Optional[Dict[str, torch.Tensor]]:
    """The trained bi-encoder artifact for this architecture, or None."""
    out = load_params_npz(_artifact("embedder", bert_cfg), template)
    if out is not None:
        logger.info("embedder: using shipped pretrained weights (%s)",
                    _artifact("embedder", bert_cfg))
    return out


def shipped_cross_encoder_params(bert_cfg, template: Mapping[str, torch.Tensor]
                                 ) -> Optional[Dict[str, torch.Tensor]]:
    """The trained cross-encoder artifact for this architecture, or None."""
    out = load_params_npz(_artifact("cross_encoder", bert_cfg), template)
    if out is not None:
        logger.info("cross-encoder: using shipped pretrained weights (%s)",
                    _artifact("cross_encoder", bert_cfg))
    return out
