"""State carried across from the JAX package's index objects.

Builds the port's `DeviceVectorIndex` and `BM25Index` directly from the
arrays a JAX-package index holds (given as numpy arrays), without running
the port's own build: the port then searches exactly the tables the JAX
package built, which holds search semantics apart from build semantics.

A directory the JAX package's `TpuVectorStore.save` wrote needs no
conversion: the port's store reads the same format (`store_from_jax_dir`),
as `PersistentBM25Index` reads the JAX package's gzip-JSON BM25 file.

Model weights: `bert_params_from_jax` / `cross_encoder_params_from_jax`
turn a flax parameter tree (numpy leaves) into the port's `state_dict`. The
port's modules carry the flax names, so each leaf is renamed (`kernel`,
`scale`, `embedding` -> `weight`) and each Dense kernel (in, out) is
transposed to the (out, in) layout of `nn.Linear`; `params_to_flat` goes
back. Training: `train_state_from_jax` carries a JAX TrainState's params
and AdamW moments into the port's `TrainState`, and
`embedder_checkpoint_from_jax` writes a JAX-trained params tree as a port
checkpoint (`parallel/checkpoint.py`), which `Embedder` restores.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from radiant_rag_tpu_torch.config import IndexConfig, QuantizationConfig
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.store import TpuVectorStore


def _dev(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a.copy()).to(device)


def engine_from_jax_state(*, vecs: np.ndarray, i8: np.ndarray, i8_lo: np.ndarray,
                          i8_hi: np.ndarray, codes: np.ndarray, valid: np.ndarray,
                          level: np.ndarray, lang: np.ndarray, doc_len: np.ndarray,
                          count: int, capacity: int, device=None,
                          **engine_kwargs) -> DeviceVectorIndex:
    """A DeviceVectorIndex over the JAX engine's full-capacity arrays
    (`codes` are its uint32 sign words, kept bit for bit as int32)."""
    dim = int(i8.shape[1])
    eng = DeviceVectorIndex(dim, initial_capacity=capacity, device=device,
                            store_fp32=vecs.shape[0] > 0, **engine_kwargs)
    if eng.capacity != capacity:
        raise ValueError(f"capacity {capacity} is not a capacity the engine rounds to")
    d = eng.device
    eng.vecs = _dev(vecs, d).to(eng.vec_dtype)
    eng.i8 = _dev(i8, d, np.int8)
    eng.codes = _dev(np.asarray(codes, np.uint32).view(np.int32), d)
    eng.valid = _dev(valid, d, bool)
    eng.level = _dev(level, d, np.int8)
    eng.lang = _dev(lang, d, np.int32)
    eng.doc_len = _dev(doc_len, d, np.float32)
    eng.i8_lo = _dev(i8_lo, d, np.float32)
    eng.i8_hi = _dev(i8_hi, d, np.float32)
    eng.count = int(count)
    eng._calibrated = True
    return eng


def bm25_from_jax_state(*, terms: Sequence[str], df: Sequence[int],
                        term_start: np.ndarray, term_idf: np.ndarray,
                        post_rows: np.ndarray, post_tf: np.ndarray,
                        doc_lens: Dict[int, int], sketch: Optional[np.ndarray] = None,
                        sketch_scale: Optional[float] = None,
                        bins_per_term: Optional[np.ndarray] = None,
                        signs_per_term: Optional[np.ndarray] = None,
                        dm_tids: Optional[np.ndarray] = None,
                        dm_tfs: Optional[np.ndarray] = None, device=None,
                        **index_kwargs) -> BM25Index:
    """A BM25Index over the JAX index's finalized CSR (`_term_start`,
    `_term_idf`, the host postings), doc lengths and, when given, its
    impact sketch with its scale and per-term bins / signs, and its
    doc-major tables. `index_kwargs` are the JAX index's constructor
    arguments (sketch_dim, routing thresholds, ...)."""
    bm = BM25Index(device=device, **index_kwargs)
    d = bm.device
    bm.terms = list(terms)
    bm.vocab = {t: i for i, t in enumerate(bm.terms)}
    bm.df = [int(x) for x in df]
    bm.doc_lens = {int(r): int(n) for r, n in doc_lens.items()}
    bm.total_len = sum(bm.doc_lens.values())
    total = int(term_start[-1])
    bm._base_start = np.asarray(term_start, np.int64).copy()
    bm._base_rows = np.asarray(post_rows, np.int32)[:total].copy()
    bm._base_tfs = np.asarray(post_tf, np.float32)[:total].copy()
    bm._term_start = bm._base_start.copy()
    bm._term_idf = np.asarray(term_idf, np.float32).copy()
    bm._host_post_rows = np.asarray(post_rows, np.int32).copy()
    bm._host_post_tf = np.asarray(post_tf, np.float32).copy()
    bm._dev_post_rows = _dev(bm._host_post_rows, d)
    bm._dev_post_tf = _dev(bm._host_post_tf, d)
    bm._csr_dirty = False
    if sketch is not None:
        bm.plan_hbm(int(sketch.shape[0]))
        if bm.sketch_dim != sketch.shape[1]:
            raise ValueError(f"sketch width {sketch.shape[1]} != planned {bm.sketch_dim}")
        bm._sketch = _dev(sketch, d, np.int8)
        bm._sketch_scale = torch.tensor(float(sketch_scale), dtype=torch.float32, device=d)
        bm._sketch_rows = int(sketch.shape[0])
        bm._sketch_dirty = False
        bm._bins_per_term = np.asarray(bins_per_term, np.int32).copy()
        bm._signs_per_term = np.asarray(signs_per_term, np.int8).copy()
    if dm_tids is not None:
        bm._dm_tids = _dev(dm_tids, d, np.int32)
        bm._dm_tfs = _dev(dm_tfs, d, np.int32)
        bm._dm_rows = int(dm_tids.shape[0])
        bm._dm_width = bm.doc_major_width = int(dm_tids.shape[1])
        bm._dm_dirty = False
    return bm


def store_from_jax_dir(path: str, index_config: Optional[IndexConfig] = None,
                       quantization: Optional[QuantizationConfig] = None,
                       device=None) -> TpuVectorStore:
    """The port's store over a directory the JAX package's store saved
    (`docs/` segments, `engine.npz`, `manifest.json`)."""
    return TpuVectorStore.load(path, index_config=index_config, quantization=quantization,
                               device=device)


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def params_from_flat(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state_dict from flax leaves keyed by '/'-joined tree paths
    (`layer_0/attention/query/kernel`, an npz artifact's keys without the
    leading `params/`)."""
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.asarray(value, np.float32)
        arr = np.array(arr.T if leaf == "kernel" else arr, order="C")  # an owned copy
        out[".".join(path + [_LEAF_NAMES[leaf]])] = torch.from_numpy(arr)
    return out


_FLAX_LEAF_NAMES = {nn.Linear: {"weight": "kernel", "bias": "bias"},
                    nn.LayerNorm: {"weight": "scale", "bias": "bias"},
                    nn.Embedding: {"weight": "embedding"}}


def params_to_flat(model: nn.Module, tensors: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """params_from_flat's inverse: float32 numpy leaves keyed by flax tree
    paths (Dense kernels back to (in, out)) from tensors named as `model`'s
    parameters (its state_dict, or its AdamW moments)."""
    kinds = {name: type(m) for name, m in model.named_modules()}
    out = {}
    for key, value in tensors.items():
        mod, _, leaf = key.rpartition(".")
        flax_leaf = _FLAX_LEAF_NAMES[kinds[mod]][leaf]
        arr = value.detach().float().cpu().numpy()
        out["/".join(mod.split(".") + [flax_leaf])] = np.ascontiguousarray(
            arr.T if flax_leaf == "kernel" else arr)
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, f"{prefix}{name}/"))
        else:
            flat[prefix + name] = value
    return flat


def _unwrap(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def bert_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A `BertEncoder` state_dict from the JAX package's BertEncoder params
    ({"params": {...}} or the inner tree, numpy leaves)."""
    tree = _unwrap(tree)
    if "bert" in tree:
        raise ValueError("a cross-encoder tree: use cross_encoder_params_from_jax")
    return params_from_flat(_flatten(tree))


def cross_encoder_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A `CrossEncoderModel` state_dict (bert.*, pooler, classifier) from the
    JAX package's CrossEncoderModel params."""
    tree = _unwrap(tree)
    if set(tree) != {"bert", "pooler", "classifier"}:
        raise ValueError(f"not a cross-encoder tree: {sorted(tree)}")
    return params_from_flat(_flatten(tree))


def _adam_state(opt_state) -> Any:
    """The ScaleByAdamState (count, mu, nu) inside an optax adamw state."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def train_state_from_jax(params_tree: Mapping[str, Any], opt_state: Any, into):
    """Load a JAX TrainState's params tree and `optax.adamw` state (numpy
    leaves, `jax.device_get` of both) into the port's `TrainState` `into`
    (built by `make_train_state` / `make_ce_train_state` with the same
    architecture and schedule): params, AdamW's mu and nu (kernels
    transposed as the params) and its count, which becomes `into.step`.
    Returns `into`."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the optax state")
    params, mu, nu = (params_from_flat(_flatten(_unwrap(t)))
                      for t in (params_tree, adam.mu, adam.nu))
    return into.load(params, mu, nu, int(np.asarray(adam.count)))


def embedder_checkpoint_from_jax(params_tree: Mapping[str, Any], directory: str,
                                 step: int) -> None:
    """Write a JAX-trained bi-encoder params tree (numpy leaves, as the JAX
    package's `TrainCheckpointer(dir).restore()["params"]` returns it) as
    step `step` of a port checkpoint in `directory`, which an `Embedder`
    with `embedding.checkpoint_dir` = directory then serves. The moments
    are written as zeros."""
    from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

    tree = _unwrap(params_tree)
    if "bert" in tree:
        raise ValueError("a cross-encoder tree: the embedder's checkpoint takes a BertEncoder's")
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(tree).items()}
    TrainCheckpointer(directory).save_arrays(step, flat, count=step)
