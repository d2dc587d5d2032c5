"""Vector-store factory: the port's `create_vector_store` for the `tpu`
(device engine), `sharded` (corpus-sharded pod store) and `numpy` (host
parity) backends.

`sharded` builds the `tpu` store from the config as its durable source and
freezes its rows into a `ShardedVectorStore` over a mesh of
`mesh.data_axis` x `mesh.model_axis` devices: every visible CUDA device
(device=None or a CUDA device), or the one CPU device when the caller asks
for the CPU. Unlike the JAX package, a persisted index that fails to load
raises instead of starting empty (and being overwritten by the next save).
"""

from __future__ import annotations

import logging
import os

from radiant_rag_tpu_torch.config import AppConfig
from radiant_rag_tpu_torch.index.base import BaseVectorStore

logger = logging.getLogger(__name__)


def _create_tpu_store(config: AppConfig, device=None):
    """Load the persisted index under index.data_dir when present (and
    index.auto_persist is on), else start empty."""
    from radiant_rag_tpu_torch.index.store import TpuVectorStore

    manifest = os.path.join(config.index.data_dir, "manifest.json")
    if config.index.auto_persist and os.path.isfile(manifest):
        store = TpuVectorStore.load(config.index.data_dir, index_config=config.index,
                                    quantization=config.quantization, device=device)
        if store.dim != config.index.dim:
            raise ValueError(
                f"persisted index at {config.index.data_dir!r} has dim={store.dim} but "
                f"config.index.dim={config.index.dim}; set index.dim to match the saved "
                "index, or point index.data_dir elsewhere / clear it to re-ingest")
        logger.info("loaded persisted index from %s (%d docs)", config.index.data_dir,
                    store.count_documents())
        return store
    return TpuVectorStore(dim=config.index.dim, index_config=config.index,
                          quantization=config.quantization, device=device)


def create_vector_store(config: AppConfig, device=None) -> BaseVectorStore:
    """Dispatch on config.index.backend (device=None: cuda)."""
    backend = config.index.backend
    if backend == "tpu":
        return _create_tpu_store(config, device)
    if backend == "numpy":
        from radiant_rag_tpu_torch.index.numpy_store import NumpyVectorStore

        return NumpyVectorStore(dim=config.index.dim, quantization=config.quantization)
    if backend == "sharded":
        from radiant_rag_tpu_torch import resolve_device
        from radiant_rag_tpu_torch.parallel.mesh import create_mesh
        from radiant_rag_tpu_torch.parallel.sharded_store import ShardedVectorStore

        dev = resolve_device(device)
        mesh = create_mesh(data=config.mesh.data_axis, model=config.mesh.model_axis,
                           devices=[dev] if dev.type == "cpu" else None)
        return ShardedVectorStore(mesh, _create_tpu_store(config, dev))
    raise ValueError(f"unknown index backend: {backend!r} (expected tpu|sharded|numpy)")
