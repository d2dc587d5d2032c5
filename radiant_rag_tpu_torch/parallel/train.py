"""Contrastive training of the bi-encoder and training of the cross-encoder.

Counterpart of `radiant_rag_tpu/parallel/train.py` on one device: the
InfoNCE loss over in-batch and mined hard negatives, the cross-encoder's
pointwise and listwise losses, the train states and the training steps.
Plain PyTorch autograd and `torch.optim.AdamW`: the JAX package trains
with XLA autodiff and `optax.adamw`, with no Pallas kernel on the path.
`param_partition_specs` (the dp x tp layout) belongs to the distributed
half of ROADMAP queue A item 12 and is not here.

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
  * the losses on `BertEncoder` / `CrossEncoderModel` called directly in
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
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radiant_rag_tpu_torch import resolve_device, to_device
from radiant_rag_tpu_torch.models.bert import (
    BertConfig, BertEncoder, init_module, l2_normalize, mean_pool,
)
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoderModel

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


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState(params, opt_state, step) on one device: the model
    holds the float32 params, the optimizer the AdamW moments, and `step`
    the count of updates (optax's count). The schedule is what
    `make_train_state` built it from."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    learning_rate: float
    schedule_steps: int
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def lr(self) -> float:
        return lr_at(self.step, self.learning_rate, self.schedule_steps)

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(mu, nu) by parameter name; zeros before the first step."""
        mu, nu = {}, {}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            mu[name] = st.get("exp_avg", torch.zeros_like(p))
            nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        return mu, nu

    def load(self, params: Mapping[str, Any], mu: Mapping[str, Any], nu: Mapping[str, Any],
             count: int) -> "TrainState":
        """Set params, both moments and the count (a restore or a JAX state
        carried across); every parameter must be given at its shape."""
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        for name, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": _like(mu[name], p, f"mu {name}"),
                "exp_avg_sq": _like(nu[name], p, f"nu {name}")}
        self.step = int(count)
        return self


def _like(value, p: torch.Tensor, what: str) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    if tuple(t.shape) != tuple(p.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(p.shape)}")
    return t.to(device=p.device, dtype=p.dtype).clone()


def _state(model: nn.Module, init_params_tree, seed: int, learning_rate: float,
           schedule_steps: int, device) -> TrainState:
    dev = resolve_device(device)
    lr_at(0, learning_rate, schedule_steps)  # refuse a schedule optax refuses
    if init_params_tree is not None:
        model.load_state_dict(init_params_tree)
    else:
        init_module(model, seed)
    model.to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(ADAM_B1, ADAM_B2),
                            eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)
    return TrainState(model, opt, learning_rate, schedule_steps)


def make_train_state(cfg: BertConfig, learning_rate: float = 2e-5, seed: int = 0,
                     schedule_steps: int = 0, init_params_tree=None,
                     device=None) -> TrainState:
    """A BertEncoder (seeded init, or `init_params_tree`, a state_dict) on
    `device` and its AdamW. schedule_steps > 0 turns on the warmup + cosine
    schedule (`lr_at`)."""
    return _state(BertEncoder(cfg), init_params_tree, seed, learning_rate, schedule_steps,
                  device)


def make_ce_train_state(cfg: BertConfig, learning_rate: float = 2e-5, seed: int = 0,
                        schedule_steps: int = 0, init_params_tree=None,
                        device=None) -> TrainState:
    """The cross-encoder's analog of make_train_state (BERT + pooler +
    one-logit classifier)."""
    return _state(CrossEncoderModel(cfg), init_params_tree, seed, learning_rate,
                  schedule_steps, device)


def _embed(model: BertEncoder, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return l2_normalize(mean_pool(model(ids, mask), mask))


def info_nce_loss(model: BertEncoder, batch: Mapping[str, torch.Tensor],
                  temperature: float = 0.05) -> Tuple[torch.Tensor, Metrics]:
    """Symmetric InfoNCE over in-batch negatives, plus mined hard negatives
    when the batch has n_ids / n_mask (B * H rows): they widen the q -> d
    softmax to B + B * H columns; the d -> q direction sees only the
    in-batch columns. Accuracy is the argmax over all columns (the first
    index on ties). The logits are float32 (`mean_pool` casts)."""
    zq = _embed(model, batch["q_ids"], batch["q_mask"])
    zd = _embed(model, batch["d_ids"], batch["d_mask"])
    logits = (zq @ zd.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    if "n_ids" in batch:
        zn = _embed(model, batch["n_ids"], batch["n_mask"])
        logits = torch.cat([logits, (zq @ zn.T) / temperature], dim=1)
    loss_qd = F.cross_entropy(logits, labels)
    loss_dq = F.cross_entropy(logits[:, :zd.shape[0]].T, labels)
    loss = 0.5 * (loss_qd + loss_dq)
    acc = (torch.argmax(logits, dim=1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def ce_pointwise_loss(model: CrossEncoderModel, batch: Mapping[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Metrics]:
    """Pointwise binary cross-entropy of each pair's logit against its
    {0, 1} label, in optax's log-sigmoid form."""
    logits = model(batch["ids"], batch["mask"], batch["type_ids"])
    labels = batch["labels"].float()
    loss = -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits)).mean()
    acc = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def ce_listwise_loss(model: CrossEncoderModel, batch: Mapping[str, torch.Tensor],
                     group: int) -> Tuple[torch.Tensor, Metrics]:
    """Softmax cross-entropy over each block of `group` pairs that share a
    pseudo-query, positive first (`data.CrossEncoderPairSampler`);
    accuracy is the share of groups ranking their positive first."""
    logits = model(batch["ids"], batch["mask"], batch["type_ids"])
    g = logits.reshape(-1, group)
    labels = torch.zeros(g.shape[0], dtype=torch.long, device=g.device)
    loss = F.cross_entropy(g, labels)
    acc = (torch.argmax(g, dim=1) == 0).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


StepFn = Callable[[TrainState, Mapping[str, torch.Tensor]], Tuple[TrainState, Metrics]]


def _step(loss_fn) -> StepFn:
    def step(state: TrainState, batch: Mapping[str, torch.Tensor]) -> Tuple[TrainState, Metrics]:
        """One update; the metrics stay on the device until the caller
        fetches them."""
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def _placer(device) -> Callable[[Mapping[str, np.ndarray]], Dict[str, torch.Tensor]]:
    dev = resolve_device(device)

    def place_batch(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The host batch's arrays as tensors on the device."""
        return {k: to_device(np.asarray(v), dev) for k, v in batch.items()}

    return place_batch


def contrastive_train_step(device=None, temperature: float = 0.05):
    """(step, place_batch) for the bi-encoder: step(state, batch) ->
    (state, metrics) runs info_nce_loss, its backward and one AdamW update."""
    return _step(lambda model, batch: info_nce_loss(model, batch, temperature)), _placer(device)


def cross_encoder_train_step(device=None, loss: str = "listwise", group: int = 4):
    """(step, place_batch) for the cross-encoder: loss "listwise" (one of
    `group` per query block) or "pointwise" (per-pair BCE on the labels)."""
    if loss == "listwise":
        fn = lambda model, batch: ce_listwise_loss(model, batch, group)  # noqa: E731
    elif loss == "pointwise":
        fn = ce_pointwise_loss
    else:
        raise ValueError(f"loss {loss!r}: 'listwise' or 'pointwise'")
    return _step(fn), _placer(device)
