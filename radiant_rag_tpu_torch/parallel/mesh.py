"""Device mesh construction.

The port's counterpart of `radiant_rag_tpu/parallel/mesh.py`. A mesh is a
small grid of `torch.device`s with named axes:

  data   shards the corpus row dimension (retrieval)
  model  exists so the layout keeps the JAX package's shape; the sharded
         index runs its shards over the flattened (data, model) product

`devices=None` takes every visible CUDA device once and raises without a
card. An explicit `devices` list may name one device more than once: those
are logical shards on one device, the port's counterpart of XLA's forced
host device count (the CPU tests' 8 x cpu mesh, or 4 x cuda:0 on one card).
The config path (`index/factory.py`) never repeats a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """A grid of devices; `processes` (multihost meshes only) holds the
    rank that owns each entry."""

    devices: np.ndarray  # object array of torch.device, shape = axis sizes
    axis_names: Tuple[str, ...]
    processes: Optional[np.ndarray] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def shards(self) -> List[torch.device]:
        """The shard devices in row-major order of the grid: shard s holds
        corpus rows [s * rows_per_shard, (s + 1) * rows_per_shard)."""
        return list(self.devices.reshape(-1))

    @property
    def first(self) -> torch.device:
        """Where per-shard results are gathered and merged."""
        return self.shards[0]


def _grid(devs: Sequence[torch.device], shape: Tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = list(devs)
    return grid.reshape(shape)


def visible_cuda_devices() -> List[torch.device]:
    """Every visible CUDA device once; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("create_mesh takes every visible CUDA device by default and none "
                           "is available; pass devices=[torch.device('cpu')] for the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(data: int = -1, model: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'model') mesh. data=-1 -> all remaining devices."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_cuda_devices())
    n = len(devs)
    if model <= 0:
        model = 1
    if data <= 0:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return Mesh(_grid(devs[: data * model], (data, model)), ("data", "model"))


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return {name: size for name, size in zip(mesh.axis_names, mesh.shape)}
