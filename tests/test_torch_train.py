"""Training parity: the port's losses, gradients, AdamW steps, learning-rate
schedule, train states and checkpoints against the JAX package's on the
CPU, float32, from the same init (the JAX params carried across with
`convert.bert_params_from_jax` / `cross_encoder_params_from_jax`) and the
same batches (numpy, from a seed). The JAX runs use a one-device mesh
(data = 1, model = 1), the port's one device.

Tolerance (float32):
  * losses and metrics: rtol 1e-5 / atol 1e-6;
  * gradients: atol 1e-6 + rtol 1e-4 (summation order through the layer,
    the softmaxes and the pooling);
  * params after 1 and 3 AdamW steps (lr 1e-3, warmup + cosine): atol
    2e-5. Not the attention key biases: softmax is invariant to them, so
    their exact gradient is 0 and both frameworks compute rounding noise
    (held below 1e-6 in both), which Adam scales to steps of up to lr:
    those, and the classifier's bias under the listwise loss (the softmax
    over a group is invariant to it), are held within steps x lr;
  * the learning rate: within 1e-6 x the peak lr of optax's schedule,
    which runs in float32 (its warmup's (init - peak) + peak cancels).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.parallel import train as jtrain
from radiant_rag_tpu.parallel.checkpoint import TrainCheckpointer as JaxCheckpointer
from radiant_rag_tpu.parallel.mesh import create_mesh
from radiant_rag_tpu_torch.convert import (
    _flatten, _unwrap, bert_params_from_jax, cross_encoder_params_from_jax,
    embedder_checkpoint_from_jax, params_to_flat, train_state_from_jax,
)
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.parallel import train as ttrain
from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

TINY = dict(vocab_size=300, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64)
LR, SCHEDULE = 1e-3, 20
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 2e-5
GROUP = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, kind, hard=True):
    r = np.random.default_rng(seed)
    if kind == "contrastive":
        b, s = 6, 16
        out = {}
        for side, rows in (("q", b), ("d", b), ("n", 2 * b)):
            if side == "n" and not hard:
                continue
            mask = (np.arange(s)[None, :] < r.integers(3, s + 1, (rows, 1))).astype(np.int32)
            out[f"{side}_ids"] = (r.integers(1, 300, (rows, s)) * mask).astype(np.int32)
            out[f"{side}_mask"] = mask
        return out
    n, s = 4 * GROUP, 24
    mask = (np.arange(s)[None, :] < r.integers(5, s + 1, (n, 1))).astype(np.int32)
    types = (np.arange(s)[None, :] >= r.integers(2, 5, (n, 1))).astype(np.int32) * mask
    labels = np.tile(np.eye(GROUP, dtype=np.int32)[0], n // GROUP)
    return {"ids": (r.integers(1, 300, (n, s)) * mask).astype(np.int32), "mask": mask,
            "type_ids": types, "labels": labels}


@functools.lru_cache(maxsize=None)
def _jax_setup(kind, schedule_steps):
    """The JAX model, optimizer and jitted step of one kind, built once per
    module (its compile is the slow part), and its init params in numpy."""
    mesh = create_mesh(data=1, model=1)
    make = jtrain.make_train_state if kind == "contrastive" else jtrain.make_ce_train_state
    state, model, tx, shardings = make(JaxBertConfig(dtype=jnp.float32, **TINY), mesh, LR,
                                       seed=3, schedule_steps=schedule_steps)
    if kind == "contrastive":
        step, place = jtrain.contrastive_train_step(model, tx, mesh)
    else:
        step, place = jtrain.cross_encoder_train_step(model, tx, mesh, loss=kind[3:],
                                                      group=GROUP)
    return _np(state.params), model, tx, step, place, shardings


def _jax_state(kind, schedule_steps=SCHEDULE):
    """A fresh JAX TrainState at count 0 (the jitted step donates it)."""
    params, model, tx, step, place, shardings = _jax_setup(kind, schedule_steps)
    params = jax.device_put(params, shardings)  # as placed there: one compile of the step
    state = jtrain.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32))
    return state, model, step, place


def _port_state(kind, jparams, schedule_steps=SCHEDULE):
    cfg = BertConfig(dtype=torch.float32, **TINY)
    if kind == "contrastive":
        state = ttrain.make_train_state(cfg, learning_rate=LR, schedule_steps=schedule_steps, device="cpu",
                                        init_params_tree=bert_params_from_jax(_np(jparams)))
        step, place = ttrain.contrastive_train_step("cpu")
    else:
        state = ttrain.make_ce_train_state(
            cfg, learning_rate=LR, schedule_steps=schedule_steps, device="cpu",
            init_params_tree=cross_encoder_params_from_jax(_np(jparams)))
        step, place = ttrain.cross_encoder_train_step("cpu", loss=kind[3:], group=GROUP)
    return state, step, place


@functools.lru_cache(maxsize=None)
def _jax_loss_fn(kind):
    model = _jax_setup(kind, SCHEDULE)[1]
    if kind == "contrastive":
        return lambda p, b: jtrain.info_nce_loss(model, p, b)
    if kind == "ce_pointwise":
        return lambda p, b: jtrain.ce_pointwise_loss(model, p, b)
    return lambda p, b: jtrain.ce_listwise_loss(model, p, b, GROUP)


@functools.lru_cache(maxsize=None)
def _jax_jitted(kind, grad):
    fn = _jax_loss_fn(kind)
    return jax.jit(jax.grad(lambda p, b: fn(p, b)[0]) if grad else fn)


def _jax_loss(kind, params, batch, grad=False):
    """The JAX loss (and metrics), or its gradient, jitted once per kind."""
    return _jax_jitted(kind, grad)(params, {k: jnp.asarray(v) for k, v in batch.items()})


def _port_loss(kind, state, batch):
    rows = [{k: torch.from_numpy(v) for k, v in batch.items()}]  # the (1, 1) mesh's one row
    if kind == "contrastive":
        return ttrain.info_nce_loss(state, rows)
    if kind == "ce_pointwise":
        return ttrain.ce_pointwise_loss(state, rows)
    return ttrain.ce_listwise_loss(state, rows, GROUP)


def _zero_grad(key, kind):
    """Leaves whose exact gradient is 0: softmax is invariant to the
    attention key biases, and the listwise softmax over a group to the
    classifier's bias."""
    return key.endswith("attention/key/bias") or (kind == "ce_listwise"
                                                  and key == "classifier/bias")


def _assert_params(jparams, state, steps, kind, what=""):
    """Every leaf within PARAM_ATOL, the zero-gradient leaves within
    steps x lr (module doc)."""
    ref = _flatten(_unwrap(_np(jparams)))
    got = params_to_flat(state.model, state.params)
    assert set(ref) == set(got)
    for key in ref:
        tol = steps * LR if _zero_grad(key, kind) else PARAM_ATOL
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=tol, err_msg=f"{what} {key}")


KINDS = ["contrastive", "ce_pointwise", "ce_listwise"]


@pytest.mark.parametrize("kind,hard", [("contrastive", True), ("contrastive", False),
                                       ("ce_pointwise", False), ("ce_listwise", False)])
def test_losses_match_jax(kind, hard):
    """info_nce_loss with and without mined hard negatives and both
    cross-encoder losses: loss and accuracy."""
    jstate, _, _, _ = _jax_state(kind)
    tstate, _, _ = _port_state(kind, jstate.params)
    batch = _batch(1, kind, hard)
    jloss, jmet = _jax_loss(kind, jstate.params, batch)
    with torch.no_grad():
        tloss, tmet = _port_loss(kind, tstate, batch)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(tmet[key].item(), float(jmet[key]), **LOSS)
    if kind == "contrastive" and hard:  # the negatives widen the q -> d softmax
        nohard = {k: v for k, v in batch.items() if not k.startswith("n_")}
        with torch.no_grad():
            assert _port_loss(kind, tstate, nohard)[0].item() != pytest.approx(tloss.item())


def test_info_nce_accuracy_takes_the_first_index_on_ties():
    """Equal documents tie every column: argmax takes the first, so only
    query 0 counts as right, in both packages."""
    jstate, _, _, _ = _jax_state("contrastive")
    tstate, _, _ = _port_state("contrastive", jstate.params)
    batch = _batch(2, "contrastive", hard=False)
    for side in ("q", "d"):
        batch[f"{side}_ids"][:] = batch[f"{side}_ids"][0]
        batch[f"{side}_mask"][:] = batch[f"{side}_mask"][0]
    _, jmet = _jax_loss("contrastive", jstate.params, batch)
    with torch.no_grad():
        _, tmet = _port_loss("contrastive", tstate, batch)
    assert tmet["accuracy"].item() == float(jmet["accuracy"]) == pytest.approx(1 / 6)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax(kind):
    jstate, _, _, _ = _jax_state(kind)
    tstate, _, _ = _port_state(kind, jstate.params)
    batch = _batch(3, kind)
    jgrads = _jax_loss(kind, jstate.params, batch, grad=True)
    loss, _ = _port_loss(kind, tstate, batch)
    loss.backward()
    got = params_to_flat(tstate.model, tstate.grads)
    ref = _flatten(_unwrap(_np(jgrads)))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **GRAD)
        if _zero_grad(key, kind):
            assert np.abs(ref[key]).max() < 1e-6 and np.abs(got[key]).max() < 1e-6


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_jax(kind, steps):
    """1 and 3 steps on fresh batches with the schedule on: each step's
    loss and accuracy, the params and the count."""
    jstate, _, jstep, jplace = _jax_state(kind)
    tstate, tstep, tplace = _port_state(kind, jstate.params)
    for i in range(steps):
        batch = _batch(10 + i, kind)
        jstate, jmet = jstep(jstate, jplace(batch))
        tstate, tmet = tstep(tstate, tplace(batch))
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(tmet[key].item(), float(jmet[key]), **LOSS)
    assert tstate.step == int(jstate.step) == steps
    _assert_params(jstate.params, tstate, steps, kind, f"after {steps}")


@pytest.mark.parametrize("kind", ["contrastive", "ce_listwise"])
def test_jax_state_carried_in_continues_the_same(kind):
    """A JAX state at count 2 (params, mu, nu, count) carried into the port
    by train_state_from_jax continues as the JAX run continues."""
    jstate, _, jstep, jplace = _jax_state(kind)
    for i in range(2):
        jstate, _ = jstep(jstate, jplace(_batch(20 + i, kind)))
    tstate, tstep, tplace = _port_state(kind, jstate.params)  # a fresh optimizer
    train_state_from_jax(_np(jstate.params), _np(jstate.opt_state), tstate)
    assert tstate.step == 2
    mu, nu = tstate.moments()
    adam = jstate.opt_state[0]
    for port, jax_ in ((mu, adam.mu), (nu, adam.nu)):
        ref = _flatten(_unwrap(_np(jax_)))
        got = params_to_flat(tstate.model, port)
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    assert tstate.lr() == pytest.approx(float(optax.warmup_cosine_decay_schedule(
        LR * 0.01, LR, 2, SCHEDULE, LR * 0.1)(2)), rel=1e-6)
    for i in range(2, 4):
        batch = _batch(20 + i, kind)
        jstate, jmet = jstep(jstate, jplace(batch))
        tstate, tmet = tstep(tstate, tplace(batch))
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), **LOSS)
    assert tstate.step == int(jstate.step) == 4
    _assert_params(jstate.params, tstate, 2, kind, "carried")


@pytest.mark.parametrize("lr,steps", [(1e-3, 20), (1e-4, 12000), (5e-5, 9), (2e-5, 2)])
def test_learning_rate_equals_optax_schedule_at_every_step(lr, steps):
    """lr_at against optax.warmup_cosine_decay_schedule as make_train_state
    builds it, at every count of the run and past its end."""
    warmup = max(1, steps // 10)
    sched = optax.warmup_cosine_decay_schedule(init_value=lr * 0.01, peak_value=lr,
                                               warmup_steps=warmup, decay_steps=steps,
                                               end_value=lr * 0.1)
    counts = np.arange(steps + 5)
    ref = np.asarray(jax.vmap(sched)(jnp.asarray(counts, jnp.int32)), np.float64)
    got = np.asarray([ttrain.lr_at(int(c), lr, steps) for c in counts])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * lr)
    assert ttrain.lr_at(7, lr, 0) == lr  # no schedule: constant


def test_learning_rate_set_before_each_step():
    """The param group's lr during each update is the schedule at the
    count before it, and the optimizer is optax.adamw's."""
    cfg = BertConfig(dtype=torch.float32, **TINY)
    state = ttrain.make_train_state(cfg, learning_rate=LR, schedule_steps=SCHEDULE,
                                    device="cpu")
    group = state.optimizer.param_groups
    assert len(group) == 1 and len(group[0]["params"]) == len(list(state.model.parameters()))
    assert (group[0]["betas"], group[0]["eps"], group[0]["weight_decay"]) == \
        ((0.9, 0.999), 1e-8, 1e-4)
    step, place = ttrain.contrastive_train_step("cpu")
    seen = []
    orig = state.optimizer.step
    state.optimizer.step = lambda: (seen.append(group[0]["lr"]), orig())[1]
    for i in range(4):
        state, _ = step(state, place(_batch(30 + i, "contrastive")))
    assert seen == [ttrain.lr_at(c, LR, SCHEDULE) for c in range(4)]
    with pytest.raises(ValueError, match="no cosine decay"):  # optax refuses it too
        ttrain.make_train_state(cfg, learning_rate=LR, schedule_steps=1, device="cpu")


def test_bf16_step_keeps_float32_params_and_is_finite():
    """bfloat16 compute: the params and both moments stay float32."""
    state = ttrain.make_train_state(BertConfig(dtype=torch.bfloat16, **TINY), learning_rate=LR,
                                    seed=1, device="cpu")
    step, place = ttrain.contrastive_train_step("cpu")
    state, met = step(state, place(_batch(5, "contrastive")))
    assert np.isfinite(met["loss"].item())
    mu, nu = state.moments()
    for tensors in (state.params, mu, nu):
        assert all(t.dtype == torch.float32 for t in tensors.values())


@pytest.mark.parametrize("kind", ["contrastive", "ce_listwise"])
def test_checkpoint_round_trip(tmp_path, kind):
    """save -> restore(template=) gives the params, moments and count bit
    for bit, and the run continues as the saved one; restore() without a
    template gives flax-path numpy leaves; max_to_keep prunes the oldest."""
    jstate, _, _, _ = _jax_state(kind)
    tstate, tstep, tplace = _port_state(kind, jstate.params)
    ck = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    for i in range(3):
        tstate, _ = tstep(tstate, tplace(_batch(40 + i, kind)))
        ck.save(tstate.step, tstate)
    assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
    raw = ck.restore()
    assert raw["step"] == 3 and raw["opt_state"]["count"] == 3
    assert raw["schedule"] == {"learning_rate": LR, "schedule_steps": SCHEDULE}
    flat = params_to_flat(tstate.model, tstate.params)
    assert set(raw["params"]) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(raw["params"][key], flat[key])
    fresh, _, _ = _port_state(kind, jstate.params)
    ck.restore(template=fresh)
    assert fresh.step == 3
    for (name, a), (_, b) in zip(sorted(tstate.params.items()), sorted(fresh.params.items())):
        assert torch.equal(a, b), name
    for m_a, m_b in zip(tstate.moments(), fresh.moments()):
        for name in m_a:
            assert torch.equal(m_a[name], m_b[name]), name
    batch = _batch(50, kind)
    _, m1 = tstep(tstate, tplace(batch))
    _, m2 = tstep(fresh, tplace(batch))
    assert m1["loss"].item() == m2["loss"].item()
    assert not [p for p in (tmp_path / "ck").iterdir() if p.name.startswith(".tmp")]


def test_jax_checkpoint_serves_the_same_embeddings_in_the_port(tmp_path):
    """A JAX TrainState saved by the JAX package's orbax checkpointer,
    restored there and written by convert.embedder_checkpoint_from_jax:
    the port's Embedder restores it and embeds as the JAX Embedder that
    restored the orbax one (float32, rtol / atol 1e-5). The orbax
    directory itself raises NotImplementedError in the port."""
    from radiant_rag_tpu.config import EmbeddingConfig as JaxEmbConfig
    from radiant_rag_tpu.models.embedder import Embedder as JaxEmbedder
    from radiant_rag_tpu_torch.config import EmbeddingConfig
    from radiant_rag_tpu_torch.models.embedder import Embedder

    jstate, _, jstep, jplace = _jax_state("contrastive", schedule_steps=0)
    for i in range(2):
        jstate, _ = jstep(jstate, jplace(_batch(60 + i, "contrastive")))
    orbax_dir = tmp_path / "orbax"
    JaxCheckpointer(str(orbax_dir)).save(2, jax.device_get(jstate))
    restored = JaxCheckpointer(str(orbax_dir)).restore()["params"]
    port_dir = tmp_path / "port"
    embedder_checkpoint_from_jax(restored, str(port_dir), 2)
    assert TrainCheckpointer(str(port_dir)).latest_step() == 2
    fields = dict(dim=32, num_layers=1, num_heads=4, hidden_dim=64, vocab_size=300,
                  max_seq_len=32, batch_size=8, dtype="float32")
    jemb = JaxEmbedder(JaxEmbConfig(preset="none", checkpoint_dir=str(orbax_dir), **fields))
    temb = Embedder(EmbeddingConfig(preset="none", checkpoint_dir=str(port_dir), **fields),
                    device="cpu")
    texts = [f"checkpoint text {i} about topic {i % 3}" for i in range(11)]
    np.testing.assert_allclose(temb.embed(texts), jemb.embed(texts), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="embedder_checkpoint_from_jax"):
        Embedder(EmbeddingConfig(preset="none", checkpoint_dir=str(orbax_dir), **fields),
                 device="cpu")
