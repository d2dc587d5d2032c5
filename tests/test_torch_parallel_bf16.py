"""The dp x tp layout in bfloat16, and the JAX package at the shapes the
port refuses. The JAX side on the conftest's 8 virtual CPU devices, the
port on logical `cpu` shards (tests/_torch_parallel_world.py).

Tolerance (bfloat16, the (4, 2) step against the JAX (4, 2) step and
against the port's (1, 1) step): each step's loss within 1e-2 and the
whole update of each layer after 3 steps at cosine >= 0.99 to the other
run's. Measured here: loss 2.0e-3 / 4.1e-3 apart, cosine >= 0.996: the
row-split partial products round to bfloat16 before their sum, and the
port rounds where its single-device step does (tests/test_torch_train.py),
so Adam's sign-like first steps flip on near-zero gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.parallel import train as jtrain
from radiant_rag_tpu.parallel.mesh import create_mesh as jax_mesh
from radiant_rag_tpu_torch.convert import _flatten, _unwrap, params_to_flat

from _torch_parallel_world import (
    LOSS, LR, SCHEDULE, TINY, batches, jax_run, np_tree, port_run,
)

BF16_LOSS_ATOL, BF16_MIN_COS = 1e-2, 0.99


def _update_cos(a, b, init, layer):
    """Cosine of two runs' whole update of one layer (p - p0 over its
    tensors; the attention key bias left out, module doc)."""
    keys = [k for k in init if k.startswith(f"layer_{layer}/")
            and not k.endswith("attention/key/bias")]
    ua = np.concatenate([(a[k] - init[k]).ravel() for k in keys]).astype(np.float64)
    ub = np.concatenate([(b[k] - init[k]).ravel() for k in keys]).astype(np.float64)
    return float(ua @ ub / (np.linalg.norm(ua) * np.linalg.norm(ub)))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 2)])
def test_bf16_step_within_tolerance_of_jax_4x2_and_of_one_device(shape):
    """bfloat16 compute on a mesh: each step's loss and the update of
    every layer within the module doc's tolerance of the JAX (4, 2) run
    and of the port's (1, 1) run; the params stay float32."""
    jinit, jloss, _, jparams = jax_run("contrastive", (4, 2), "bfloat16")
    state, losses, _ = port_run("contrastive", shape, jinit, "bfloat16")
    one = port_run("contrastive", (1, 1), jinit, "bfloat16")
    init = _flatten(_unwrap(jinit))
    got = params_to_flat(state.model, state.params)
    for what, ref_losses, ref in (("JAX (4, 2)", jloss, _flatten(_unwrap(jparams))),
                                  ("port (1, 1)", one[1],
                                   params_to_flat(one[0].model, one[0].params))):
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=BF16_LOSS_ATOL, err_msg=what)
        for layer in range(TINY["num_layers"]):
            assert _update_cos(got, ref, init, layer) >= BF16_MIN_COS, what
    assert all(t.dtype == torch.float32 for t in state.params.values())




def test_jax_at_the_shapes_the_port_refuses():
    """What the JAX package does there: GSPMD splits inside a head (4
    heads, 32 wide, over model 8: four columns a shard) and runs the
    unsharded step's math; an axis that does not divide the width raises
    in device_put. The (1, 8) step's loss equals the port's (1, 1) step's
    from the same init."""
    mesh = jax_mesh(data=1, model=8)
    state, model, tx, _ = jtrain.make_train_state(JaxBertConfig(dtype=jnp.float32, **TINY),
                                                  mesh, LR, seed=3, schedule_steps=SCHEDULE)
    one = port_run("contrastive", (1, 1), np_tree(state.params))
    step, place = jtrain.contrastive_train_step(model, tx, mesh)
    _, met = step(state, place(batches("contrastive")[0]))
    np.testing.assert_allclose(float(met["loss"]), one[1][0], **LOSS)
    with pytest.raises(ValueError, match="divisible by 3"):
        jtrain.make_train_state(JaxBertConfig(dtype=jnp.float32, **TINY),
                                jax_mesh(data=1, model=3), LR, seed=3)
