"""Contrastive training of the bi-encoder and training of the cross-encoder.

Counterpart of `radiant_rag_tpu/parallel/train.py`: the InfoNCE loss
over in-batch and mined hard negatives, the cross-encoder's pointwise and
listwise losses, the train states and the training steps, on a
('data', 'model') mesh. Plain PyTorch autograd and `torch.optim.AdamW`:
the JAX package trains with XLA autodiff and `optax.adamw`, with no Pallas
kernel on the path.

The mesh. A state's parameters live as master shards on the mesh
(`parallel/tensor_parallel.py`: `param_partition_specs`, the Megatron
split over 'model', the data-row copies whose backward is the data-axis
gradient sum). `place_batch` splits the batch's rows over 'data', row
block d on device (d, 0). Each data row runs the sharded forward of its
block; the losses gather what they need onto the mesh's first device and
run there once, over the whole batch, as GSPMD's program does: the
InfoNCE logits are (B, B + B * H) over every row's embeddings (a loss per
data shard would see fewer negatives), the cross-encoder's groups are
read from the gathered logits. On the (1, 1) mesh every copy and gather
falls away: the step launches what the module's own forward, the loss,
its backward and AdamW launch.

Equal to the JAX step (float32, the same init and batch) up to summation
order:
  * AdamW as `optax.adamw(lr)` builds it: b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root of the bias-corrected second moment, bias
    correction by the step count, and weight decay 1e-4 (torch's default
    is 1e-2) on every parameter, biases, LayerNorm scales and embedding
    tables included (optax's mask=None);
  * the warmup + cosine schedule (`lr_at`), evaluated at the count before
    the step, as optax's `scale_by_learning_rate` does, and set on the
    param group before each step;
  * the forward that serves (`models/bert.py`'s `encoder_forward`), in
    grad mode (the serving wrappers run under `torch.no_grad`).
Under bfloat16 compute the parameters stay float32 and every cast's
backward casts the gradient back, as XLA's `convert_element_type`
transpose does. Two backward rounding points differ from XLA's: the
embedding tables' gradient is summed in float32 (the port gathers the
float32 rows, then casts; flax casts the table, then gathers, and sums the
bfloat16 rows), and the softmax backward reads the bfloat16 probabilities
(flax keeps its float32 softmax output for the backward).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radiant_rag_tpu_torch import resolve_device, to_device
from radiant_rag_tpu_torch.models.bert import (
    BertConfig, BertEncoder, encoder_forward, init_module, l2_normalize, mean_pool,
)
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoderModel, cross_encoder_forward
from radiant_rag_tpu_torch.parallel.mesh import Mesh, create_mesh
from radiant_rag_tpu_torch.parallel.tensor_parallel import (  # noqa: F401 (re-exported)
    ShardedParams, param_partition_specs,
)

# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

Metrics = Dict[str, torch.Tensor]


def lr_at(count: int, learning_rate: float, schedule_steps: int) -> float:
    """The learning rate of the update at `count` (0 for the first step):
    constant without a schedule, else `optax.warmup_cosine_decay_schedule`
    from lr * 0.01 up to lr over max(1, steps // 10) steps, then a cosine
    down to lr * 0.1 at schedule_steps (held there after)."""
    if schedule_steps <= 0:
        return learning_rate
    warmup = max(1, schedule_steps // 10)
    decay = schedule_steps - warmup
    if decay <= 0:  # optax's cosine_decay_schedule refuses it too
        raise ValueError(f"schedule_steps {schedule_steps} leaves no cosine decay")
    init, end = learning_rate * 0.01, learning_rate * 0.1
    if count < warmup:
        frac = 1.0 - count / warmup
        return (init - learning_rate) * frac + learning_rate
    t = min(count - warmup, decay)
    alpha = end / learning_rate if learning_rate else 0.0
    return learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)


def train_mesh(mesh: Optional[Mesh] = None, device=None) -> Mesh:
    """The mesh a trainer runs on: `mesh` as given; a named device's 1 x 1
    mesh; neither: `create_mesh()`, every visible CUDA device on 'data'."""
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if mesh is not None:
        return mesh
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return create_mesh(devices=[dev])
    return create_mesh()


def _as_mesh(mesh_or_device) -> Mesh:
    return mesh_or_device if isinstance(mesh_or_device, Mesh) else train_mesh(
        device=mesh_or_device)


def _same_mesh(a: Mesh, b: Mesh) -> bool:
    return a.shape == b.shape and all(x == y for x, y in zip(a.shards, b.shards))


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState(params, opt_state, step) on a mesh: `sharded`
    holds the float32 master shards, the optimizer their AdamW moments,
    and `step` the count of updates (optax's count). `model` is the
    architecture, on the meta device.
    The schedule is what `make_train_state` built it from. `params` and
    `moments` gather the shards into whole tensors on the mesh's first
    device (what the JAX package's `device_get` of a sharded state gives);
    `load` splits whole tensors into them."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    learning_rate: float
    schedule_steps: int
    sharded: ShardedParams
    step: int = 0

    @property
    def mesh(self) -> Mesh:
        return self.sharded.mesh

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        sh = self.sharded
        return {n: sh.gather(n, ps) for n, ps in sh.shards.items()}

    @property
    def grads(self) -> Dict[str, torch.Tensor]:
        """The masters' gradients from the last backward, whole."""
        sh = self.sharded
        return {n: sh.gather(n, [p.grad for p in ps]) for n, ps in sh.shards.items()}

    def lr(self) -> float:
        return lr_at(self.step, self.learning_rate, self.schedule_steps)

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(mu, nu) by parameter name, whole; zeros before the first step."""
        sh, mu, nu = self.sharded, {}, {}
        for name, ps in sh.shards.items():
            states = [self.optimizer.state.get(p, {}) for p in ps]
            mu[name] = sh.gather(name, [st.get("exp_avg", torch.zeros_like(p))
                                        for st, p in zip(states, ps)])
            nu[name] = sh.gather(name, [st.get("exp_avg_sq", torch.zeros_like(p))
                                        for st, p in zip(states, ps)])
        return mu, nu

    def load(self, params: Mapping[str, Any], mu: Mapping[str, Any], nu: Mapping[str, Any],
             count: int) -> "TrainState":
        """Set params, both moments and the count (a restore or a JAX state
        carried across), whole tensors split over the mesh; every parameter
        must be given at its shape."""
        sh = self.sharded
        if set(params) != set(sh.shards):
            raise ValueError(f"params: missing {sorted(set(sh.shards) - set(params))}, "
                             f"unexpected {sorted(set(params) - set(sh.shards))}")
        with torch.no_grad():
            for name, ps in sh.shards.items():
                shape = _whole_shape(ps, sh.specs[name])
                parts = [sh.split(name, _whole(v[name], shape, f"{what} {name}"))
                         for v, what in ((params, "param"), (mu, "mu"), (nu, "nu"))]
                for p, w, a, b in zip(ps, *parts):
                    p.copy_(w.to(device=p.device, dtype=p.dtype))
                    self.optimizer.state[p] = {
                        "step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": a.to(device=p.device, dtype=p.dtype).clone(),
                        "exp_avg_sq": b.to(device=p.device, dtype=p.dtype).clone()}
        self.step = int(count)
        return self


def _whole_shape(ps, dim) -> Tuple[int, ...]:
    """The whole shape of a parameter from its shards."""
    shape = list(ps[0].shape)
    if dim is not None and len(ps) > 1:
        shape[dim] = sum(p.shape[dim] for p in ps)
    return tuple(shape)


def _whole(value, shape, what: str) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def _state(model: nn.Module, cfg: BertConfig, mesh, init_params_tree, seed: int,
           learning_rate: float, schedule_steps: int, device) -> TrainState:
    mesh = train_mesh(mesh, device)
    lr_at(0, learning_rate, schedule_steps)  # refuse a schedule optax refuses
    if init_params_tree is not None:
        model.load_state_dict(init_params_tree)
    else:
        init_module(model, seed)
    sharded = ShardedParams(model, cfg, mesh)
    opt = torch.optim.AdamW(list(sharded.parameters()), lr=learning_rate,
                            betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)
    return TrainState(model, opt, learning_rate, schedule_steps, sharded)


def make_train_state(cfg: BertConfig, mesh: Optional[Mesh] = None,
                     learning_rate: float = 2e-5, seed: int = 0, schedule_steps: int = 0,
                     init_params_tree=None, device=None) -> TrainState:
    """A BertEncoder (seeded init, or `init_params_tree`, a state_dict)
    placed on `mesh` (`train_mesh`: a device's 1 x 1 mesh, or every CUDA
    device on 'data'), and its AdamW. schedule_steps > 0 turns on the
    warmup + cosine schedule (`lr_at`)."""
    return _state(BertEncoder(cfg), cfg, mesh, init_params_tree, seed, learning_rate,
                  schedule_steps, device)


def make_ce_train_state(cfg: BertConfig, mesh: Optional[Mesh] = None,
                        learning_rate: float = 2e-5, seed: int = 0, schedule_steps: int = 0,
                        init_params_tree=None, device=None) -> TrainState:
    """The cross-encoder's analog of make_train_state (BERT + pooler +
    one-logit classifier; the BERT blocks split as the bi-encoder's, the
    pooler and classifier replicated)."""
    return _state(CrossEncoderModel(cfg), cfg, mesh, init_params_tree, seed, learning_rate,
                  schedule_steps, device)


def _rows(parts: List[torch.Tensor]) -> torch.Tensor:
    """Every data row's block, in row order, on the mesh's first device:
    one row's block is the whole batch and is not copied."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _info_nce(zq: torch.Tensor, zd: torch.Tensor, zn: Optional[torch.Tensor],
              temperature: float) -> Tuple[torch.Tensor, Metrics]:
    logits = (zq @ zd.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    if zn is not None:
        logits = torch.cat([logits, (zq @ zn.T) / temperature], dim=1)
    loss_qd = F.cross_entropy(logits, labels)
    loss_dq = F.cross_entropy(logits[:, :zd.shape[0]].T, labels)
    loss = 0.5 * (loss_qd + loss_dq)
    acc = (torch.argmax(logits, dim=1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def info_nce_loss(state: TrainState, rows: Sequence[Mapping[str, torch.Tensor]],
                  temperature: float = 0.05) -> Tuple[torch.Tensor, Metrics]:
    """Symmetric InfoNCE over in-batch negatives, plus mined hard negatives
    when the batch has n_ids / n_mask (B * H rows): they widen the q -> d
    softmax to B + B * H columns; the d -> q direction sees only the
    in-batch columns. Accuracy is the argmax over all columns (the first
    index on ties). The logits are float32 (`mean_pool` casts).

    `rows` is a batch split over 'data' (`place_batch`): each data row
    embeds its block on its devices, and the embeddings are gathered onto
    the mesh's first device in row order, so the loss sees the whole
    batch's negatives."""
    sh = state.sharded
    first = sh.mesh.first
    z: Dict[str, list] = {"q": [], "d": [], "n": []}
    for d, batch in enumerate(rows):
        P, devs = sh.local(d), list(sh.mesh.devices[d])
        for side in z:
            if f"{side}_ids" in batch:
                mask = batch[f"{side}_mask"]
                hidden = encoder_forward(P, devs, sh.cfg, batch[f"{side}_ids"], mask)
                z[side].append(l2_normalize(mean_pool(hidden, mask)).to(first))
    zn = _rows(z["n"]) if z["n"] else None
    return _info_nce(_rows(z["q"]), _rows(z["d"]), zn, temperature)


def _pointwise(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    labels = labels.float()
    loss = -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits)).mean()
    acc = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def _listwise(logits: torch.Tensor, group: int) -> Tuple[torch.Tensor, Metrics]:
    g = logits.reshape(-1, group)
    labels = torch.zeros(g.shape[0], dtype=torch.long, device=g.device)
    loss = F.cross_entropy(g, labels)
    acc = (torch.argmax(g, dim=1) == 0).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def ce_logits(state: TrainState, rows: Sequence[Mapping[str, torch.Tensor]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-encoder's logits and labels of a batch split over 'data',
    gathered onto the mesh's first device in row order (a group may
    straddle two data rows, as under the JAX package's rounding)."""
    sh = state.sharded
    first = sh.mesh.first
    logits, labels = [], []
    for d, batch in enumerate(rows):
        out = cross_encoder_forward(sh.local(d), list(sh.mesh.devices[d]), sh.cfg,
                                    batch["ids"], batch["mask"], batch["type_ids"])
        logits.append(out.to(first))
        labels.append(batch["labels"].to(first))
    return _rows(logits), _rows(labels)


def ce_pointwise_loss(state: TrainState, rows: Sequence[Mapping[str, torch.Tensor]]
                      ) -> Tuple[torch.Tensor, Metrics]:
    """Pointwise binary cross-entropy of each pair's logit against its
    {0, 1} label, in optax's log-sigmoid form."""
    return _pointwise(*ce_logits(state, rows))


def ce_listwise_loss(state: TrainState, rows: Sequence[Mapping[str, torch.Tensor]],
                     group: int) -> Tuple[torch.Tensor, Metrics]:
    """Softmax cross-entropy over each block of `group` pairs that share a
    pseudo-query, positive first (`data.CrossEncoderPairSampler`);
    accuracy is the share of groups ranking their positive first."""
    return _listwise(ce_logits(state, rows)[0], group)


StepFn = Callable[[TrainState, Any], Tuple[TrainState, Metrics]]


def _step(loss_fn, mesh: Mesh) -> StepFn:
    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        """One update; the metrics stay on the device until the caller
        fetches them."""
        if not _same_mesh(state.mesh, mesh):
            raise ValueError(f"the state lives on a {state.mesh.shape} mesh of "
                             f"{state.mesh.shards}, the step on {mesh.shape} of {mesh.shards}")
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def _placer(mesh: Mesh):
    data = mesh.shape[0]
    row_devs = [mesh.devices[d, 0] for d in range(data)]

    def place_batch(batch: Mapping[str, np.ndarray]) -> List[Dict[str, torch.Tensor]]:
        """The host batch's rows split over 'data': block d on device (d, 0)."""
        out: List[Dict[str, torch.Tensor]] = [{} for _ in range(data)]
        for k, v in batch.items():
            a = np.asarray(v)
            if a.shape[0] % data:
                raise ValueError(f"batch {k!r} has {a.shape[0]} rows, which the data axis "
                                 f"({data}) does not divide")
            for d, part in enumerate(np.split(a, data)):
                out[d][k] = to_device(part, row_devs[d])
        return out

    return place_batch


def contrastive_train_step(mesh=None, temperature: float = 0.05):
    """(step, place_batch) for the bi-encoder on `mesh` (a Mesh, or a
    device for its 1 x 1 mesh; None: `create_mesh()`): step(state, batch)
    -> (state, metrics) runs the InfoNCE loss, its backward and one AdamW
    update of a state built on the same mesh."""
    mesh = _as_mesh(mesh)
    fn = lambda state, rows: info_nce_loss(state, rows, temperature)  # noqa: E731
    return _step(fn, mesh), _placer(mesh)


def cross_encoder_train_step(mesh=None, loss: str = "listwise", group: int = 4):
    """(step, place_batch) for the cross-encoder on `mesh` (as
    contrastive_train_step's): loss "listwise" (one of `group` per query
    block) or "pointwise" (per-pair BCE on the labels)."""
    mesh = _as_mesh(mesh)
    if loss == "listwise":
        fn = lambda state, rows: ce_listwise_loss(state, rows, group)  # noqa: E731
    elif loss == "pointwise":
        fn = ce_pointwise_loss
    else:
        raise ValueError(f"loss {loss!r}: 'listwise' or 'pointwise'")
    return _step(fn, mesh), _placer(mesh)
