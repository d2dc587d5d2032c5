"""Shared setup of tests/test_torch_parallel_{train,data}.py: a tiny BERT,
seeded batches, the JAX package's steps on a (data, model) mesh of the
conftest's 8 virtual CPU devices and the port's on a mesh of 8 logical
`cpu` shards, from the same init."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.parallel import train as jtrain
from radiant_rag_tpu.parallel.mesh import create_mesh as jax_mesh
from radiant_rag_tpu_torch.convert import (
    bert_params_from_jax, cross_encoder_params_from_jax, params_to_flat,
)
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.parallel import train as ttrain
from radiant_rag_tpu_torch.parallel.mesh import create_mesh

TINY = dict(vocab_size=300, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64)
LR, SCHEDULE, STEPS = 1e-3, 20, 3
LOSS = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 2e-5
GROUP = 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def make_batch(seed, kind, hard=True):
    """8 queries (+ 16 mined negatives), or 4 groups of 4 pairs: every
    mesh here divides the rows."""
    r = np.random.default_rng(seed)
    if kind == "contrastive":
        b, s = 8, 16
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


def batches(kind, hard=True):
    return [make_batch(10 + i, kind, hard) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def jax_run(kind, shape, dtype="float32", hard=True):
    """STEPS JAX steps on a (data, model) mesh of the conftest's devices:
    (init params, losses, accuracies, final params), numpy leaves."""
    mesh = jax_mesh(data=shape[0], model=shape[1])
    cfg = JaxBertConfig(dtype=DTYPES[dtype][0], **TINY)
    make = jtrain.make_train_state if kind == "contrastive" else jtrain.make_ce_train_state
    state, model, tx, _ = make(cfg, mesh, LR, seed=3, schedule_steps=SCHEDULE)
    init = np_tree(state.params)
    if kind == "contrastive":
        step, place = jtrain.contrastive_train_step(model, tx, mesh)
    else:
        step, place = jtrain.cross_encoder_train_step(model, tx, mesh, loss=kind[3:],
                                                      group=GROUP)
    losses, accs = [], []
    for batch in batches(kind, hard):
        state, met = step(state, place(batch))
        losses.append(float(met["loss"]))
        accs.append(float(met["accuracy"]))
    return init, losses, accs, np_tree(state.params)


def port_mesh(shape):
    return create_mesh(data=shape[0], model=shape[1], devices=["cpu"] * 8)


def port_run(kind, shape, jinit, dtype="float32", hard=True):
    """The port's STEPS steps on a (data, model) mesh of logical cpu shards
    from the JAX init: (state, losses, accuracies)."""
    mesh = port_mesh(shape)
    cfg = BertConfig(dtype=DTYPES[dtype][1], **TINY)
    if kind == "contrastive":
        state = ttrain.make_train_state(cfg, mesh, LR, schedule_steps=SCHEDULE,
                                        init_params_tree=bert_params_from_jax(jinit))
        step, place = ttrain.contrastive_train_step(mesh)
    else:
        state = ttrain.make_ce_train_state(cfg, mesh, LR, schedule_steps=SCHEDULE,
                                           init_params_tree=cross_encoder_params_from_jax(jinit))
        step, place = ttrain.cross_encoder_train_step(mesh, loss=kind[3:], group=GROUP)
    losses, accs = [], []
    for batch in batches(kind, hard):
        state, met = step(state, place(batch))
        losses.append(met["loss"].item())
        accs.append(met["accuracy"].item())
    return state, losses, accs


def zero_grad_leaf(key, kind):
    """Leaves whose exact gradient is 0 (module doc)."""
    return key.endswith("attention/key/bias") or (kind == "ce_listwise"
                                                  and key == "classifier/bias")


def assert_params(ref_flat, state, kind, what):
    got = params_to_flat(state.model, state.params)
    assert set(ref_flat) == set(got)
    for key in ref_flat:
        tol = STEPS * LR if zero_grad_leaf(key, kind) else PARAM_ATOL
        np.testing.assert_allclose(got[key], ref_flat[key], rtol=0, atol=tol,
                                   err_msg=f"{what} {key}")
