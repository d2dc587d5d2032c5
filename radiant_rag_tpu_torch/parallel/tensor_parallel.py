"""The dp x tp layout of training: parameter shards on a ('data', 'model')
mesh, which the forward of `BertEncoder` / `CrossEncoderModel` runs on.

The port's counterpart of the JAX package's `param_partition_specs` and
the GSPMD program it annotates (`radiant_rag_tpu/parallel/train.py`).
Megatron pairing over 'model': query / key / value / mlp_in column-split
(the `nn.Linear` weight, (out, in), split on dim 0, the bias with it),
out / mlp_out row-split (the weight split on dim 1; the bias replicated
and added once, after the reduce); everything else replicated. The heads
split with query / key / value: model shard m runs heads
[m * H / M, (m + 1) * H / M).

Where the shards live. One master copy of each shard sits on the mesh's
first data row, device (0, m) (a replicated parameter on (0, 0)). Data row
d copies each shard to (d, m) with a differentiable `.to()`, whose backward
sums row d's gradient into the master: the data-axis all-reduce, with no
hand-written collective. One AdamW steps the masters. On a device the mesh
repeats (logical shards), and on the (1, 1) mesh, the copy is a no-op.

`ShardedParams.local(d)` is data row d's parameter table, which
`models/bert.py`'s `encoder_forward` (the forward that serves too) and
`models/cross_encoder.py`'s `cross_encoder_forward` run on.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional

import torch
from torch import nn

from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.parallel.mesh import Mesh

_COLUMN = ("attention.query", "attention.key", "attention.value", "mlp_in")
_ROW = ("attention.out", "mlp_out")

Shards = Dict[str, List[torch.Tensor]]


def _layer_of(name: str) -> str:
    """The module path's last two parts (`attention.query`, `layer_0.mlp_in`)."""
    mod = name.rpartition(".")[0]
    return ".".join(mod.split(".")[-2:])


def param_partition_specs(params: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """The dim of each parameter that 'model' splits, None when replicated,
    by state_dict name. The JAX package's specs in the `nn.Linear` layout:
    a flax kernel's P(None, 'model') is dim 0 of the torch weight,
    P('model', None) dim 1, a bias's P('model') dim 0."""
    specs: Dict[str, Optional[int]] = {}
    for name, value in params.items():
        layer, leaf = _layer_of(name), name.rpartition(".")[2]
        column = any(layer.endswith(c) for c in _COLUMN)
        row = any(layer.endswith(r) for r in _ROW)
        if value.ndim == 2 and column:
            specs[name] = 0
        elif value.ndim == 2 and row:
            specs[name] = 1
        elif value.ndim == 1 and column and leaf == "bias":
            specs[name] = 0
        else:
            specs[name] = None
    return specs


def check_model_axis(cfg: BertConfig, model: int) -> None:
    """Raise unless 'model' splits the heads and the MLP evenly."""
    if cfg.num_heads % model or cfg.intermediate_size % model:
        raise ValueError(
            f"the model axis ({model}) must divide num_heads ({cfg.num_heads}) and "
            f"intermediate_size ({cfg.intermediate_size}): each model shard runs whole heads "
            "and an equal slice of the MLP")


class ShardedParams:
    """A module's parameters as master shards on `mesh` (module doc): new
    parameters split from the module's, which is left on the meta device
    as the architecture (its names and layer kinds)."""

    def __init__(self, module: nn.Module, cfg: BertConfig, mesh: Mesh) -> None:
        if mesh.axis_names != ("data", "model"):
            raise ValueError(f"a training mesh has axes ('data', 'model'), not {mesh.axis_names}")
        self.mesh, self.cfg = mesh, cfg
        self.model_size = mesh.shape[1]
        check_model_axis(cfg, self.model_size)
        first_row = list(mesh.devices[0])
        named = dict(module.named_parameters())
        self.specs = param_partition_specs(named)
        self.shards: Shards = {}
        with torch.no_grad():
            for n, p in named.items():
                self.shards[n] = [nn.Parameter(t.to(first_row[m]).clone())
                                  for m, t in enumerate(self.split(n, p.detach()))]
        module.to("meta")

    def parameters(self) -> Iterator[nn.Parameter]:
        """The masters, by name, then model shard (the module's order)."""
        for ps in self.shards.values():
            yield from ps

    def split(self, name: str, value: torch.Tensor) -> List[torch.Tensor]:
        """A whole tensor of parameter `name`'s shape as its shards."""
        dim = self.specs[name]
        if dim is None:
            return [value]
        return list(torch.chunk(value, self.model_size, dim=dim))

    def gather(self, name: str, parts: List[torch.Tensor]) -> torch.Tensor:
        """Shards of `name` (the masters, their gradients or their moments)
        as one tensor on the mesh's first device."""
        if len(parts) == 1:
            return parts[0].detach()
        first = self.mesh.first
        return torch.cat([t.detach().to(first) for t in parts], dim=self.specs[name])

    def local(self, d: int) -> Shards:
        """Data row d's parameter table: shard m on device (d, m), a
        replicated parameter on (d, 0); differentiable copies (the masters
        themselves on row 0 and on a repeated device)."""
        devs = list(self.mesh.devices[d])
        return {n: [p.to(devs[m]) for m, p in enumerate(ps)] for n, ps in self.shards.items()}
