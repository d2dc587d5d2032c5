"""The dp x tp training layout: the port's `param_partition_specs`, its
training steps on ('data', 'model') meshes and its checkpoints across
meshes, against the JAX package's on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on a
mesh of 8 logical `cpu` shards (`create_mesh(devices=["cpu"] * 8)`), from
the same init (the JAX params carried across with
`convert.bert_params_from_jax` / `cross_encoder_params_from_jax`) and the
same batches (numpy, from a seed).

Tolerance (float32), as tests/test_torch_train.py's: losses rtol 1e-5 /
atol 1e-6, accuracy equal, the params after 3 AdamW steps (lr 1e-3,
warmup + cosine) within atol 2e-5, the leaves whose exact gradient is 0
(the attention key biases; the classifier bias under the listwise loss)
within steps x lr.

The bfloat16 step and the JAX package at the shapes the port refuses are
in tests/test_torch_parallel_data.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.parallel import train as jtrain
from radiant_rag_tpu.parallel.mesh import create_mesh as jax_mesh
from radiant_rag_tpu_torch.convert import (
    _LEAF_NAMES, _flatten, _unwrap, bert_params_from_jax, cross_encoder_params_from_jax,
    params_to_flat,
)
from radiant_rag_tpu_torch.models.bert import BertConfig, BertEncoder, l2_normalize, mean_pool
from radiant_rag_tpu_torch.parallel import train as ttrain
from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

from _torch_parallel_world import (
    GROUP, LOSS, LR, STEPS, TINY, assert_params, make_batch, jax_run, np_tree, port_mesh,
    port_run,
)

def _port_key(flax_key: str) -> str:
    *path, leaf = flax_key.split("/")
    return ".".join(path + [_LEAF_NAMES[leaf]])


@pytest.mark.parametrize("kind", ["contrastive", "ce_listwise"])
def test_param_partition_specs_equal_jax(kind):
    """Every parameter's split through the rename and the transposition:
    P(None, 'model') of a (in, out) kernel is dim 0 of the (out, in)
    weight, P('model', None) dim 1, a bias's P('model') dim 0."""
    mesh = jax_mesh(data=1, model=1)
    make = jtrain.make_train_state if kind == "contrastive" else jtrain.make_ce_train_state
    state = make(JaxBertConfig(dtype=jnp.float32, **TINY), mesh, LR, seed=3)[0]
    jspecs = _flatten(_unwrap(jtrain.param_partition_specs(state.params)))
    to_dim = {P(None, "model"): 0, P("model", None): 1, P("model"): 0,
              P(None, None): None, P(None): None}
    want = {_port_key(k): to_dim[s] for k, s in jspecs.items()}
    got = ttrain.param_partition_specs((bert_params_from_jax if kind == "contrastive" else
                                        cross_encoder_params_from_jax)(np_tree(state.params)))
    assert got == want
    assert sorted(k for k, v in got.items() if v == 1) == [
        k for k in sorted(got) if k.endswith(("attention.out.weight", "mlp_out.weight"))]
    assert sum(v is not None for v in got.values()) == 10  # 4 column pairs, 2 row weights


@pytest.mark.parametrize("hard", [True, False])
def test_contrastive_4x2_step_equals_jax(hard):
    """The (4, 2) InfoNCE step with and without mined hard negatives:
    loss and accuracy of each of 3 steps, then the params."""
    jinit, jloss, jacc, jparams = jax_run("contrastive", (4, 2), hard=hard)
    state, losses, accs = port_run("contrastive", (4, 2), jinit, hard=hard)
    np.testing.assert_allclose(losses, jloss, **LOSS)
    assert accs == jacc
    assert state.step == STEPS
    assert_params(_flatten(_unwrap(jparams)), state, "contrastive", "(4, 2)")


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (8, 1), (2, 4)])
def test_every_mesh_equals_the_4x2_step(shape):
    """The same 3 steps on other meshes equal the (4, 2) step, the port's
    and the JAX package's. A loss per data shard (a replica's InfoNCE over
    its own rows, averaged) sees fewer negatives and fails here."""
    jinit, jloss, jacc, jparams = jax_run("contrastive", (4, 2))
    ref, ref_losses, ref_accs = port_run("contrastive", (4, 2), jinit)
    state, losses, accs = port_run("contrastive", shape, jinit)
    np.testing.assert_allclose(losses, ref_losses, **LOSS)
    np.testing.assert_allclose(losses, jloss, **LOSS)
    assert accs == ref_accs == jacc
    assert_params(params_to_flat(ref.model, ref.params), state, "contrastive", str(shape))
    assert_params(_flatten(_unwrap(jparams)), state, "contrastive", f"{shape} vs JAX")


@pytest.mark.parametrize("loss", ["listwise", "pointwise"])
def test_cross_encoder_2x1_step_equals_jax(loss):
    """The cross-encoder's (2, 1) step, both losses: the groups are read
    from the logits gathered over the data shards."""
    kind = f"ce_{loss}"
    jinit, jloss, jacc, jparams = jax_run(kind, (2, 1))
    state, losses, accs = port_run(kind, (2, 1), jinit)
    np.testing.assert_allclose(losses, jloss, **LOSS)
    assert accs == jacc
    assert_params(_flatten(_unwrap(jparams)), state, kind, "(2, 1)")
    ref = port_run(kind, (1, 2), jinit)
    np.testing.assert_allclose(ref[1], losses, **LOSS)
    assert_params(params_to_flat(state.model, state.params), ref[0], kind, "(1, 2)")


@pytest.mark.parametrize("kind", ["contrastive", "ce_listwise"])
@pytest.mark.parametrize("src,dst", [((2, 2), (1, 1)), ((1, 1), (2, 2))])
def test_checkpoint_restores_across_meshes_bit_for_bit(tmp_path, kind, src, dst):
    """A state saved on one mesh (its shards gathered) restores into a
    state on another bit for bit: params, both moments and the count; the
    shards of the restored state are the saved tensors split; both then
    take the same next step."""
    jinit = jax_run(kind, (4, 2))[0] if kind == "contrastive" else jax_run(kind, (2, 1))[0]
    state = port_run(kind, src, jinit)[0]
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    ck.save(state.step, state)
    other = port_run(kind, dst, jinit)[0]  # 3 steps too, to be overwritten
    other.step = 0
    ck.restore(template=other)
    assert other.step == state.step == STEPS
    mu, nu = state.moments()
    omu, onu = other.moments()
    for mine, theirs in ((state.params, other.params), (mu, omu), (nu, onu)):
        assert set(mine) == set(theirs)
        for name in mine:
            assert torch.equal(mine[name], theirs[name]), name
    for name, ps in other.sharded.shards.items():
        for p, part in zip(ps, other.sharded.split(name, state.params[name])):
            assert torch.equal(p.detach(), part), name
    batch = make_batch(99, kind)
    outs = []
    for st in (state, other):
        make = ttrain.contrastive_train_step if kind == "contrastive" else (
            lambda m: ttrain.cross_encoder_train_step(m, group=GROUP))
        step, place = make(st.mesh)
        outs.append(step(st, place(batch))[1]["loss"].item())
    np.testing.assert_allclose(outs[0], outs[1], **LOSS)


@pytest.mark.parametrize("heads,inter,model", [(4, 64, 8), (4, 66, 4), (2, 64, 4)])
def test_a_model_axis_that_does_not_divide_the_heads_or_the_mlp_raises(heads, inter, model):
    """The port runs whole heads on each model shard and refuses a model
    axis that does not divide the heads or the MLP, with the reason."""
    cfg = BertConfig(**dict(TINY, num_heads=heads, intermediate_size=inter))
    mesh = port_mesh((1, model))
    with pytest.raises(ValueError, match="must divide num_heads"):
        ttrain.make_train_state(cfg, mesh, LR)
    with pytest.raises(ValueError, match="must divide num_heads"):
        ttrain.make_ce_train_state(cfg, mesh, LR)


class _Ops(TorchDispatchMode):
    """The aten ops a block dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_one_by_one_mesh_runs_the_single_device_step_op_for_op():
    """On the (1, 1) mesh a step dispatches exactly the ops of the plain
    single-device step (a `BertEncoder`'s own forward, the InfoNCE, its
    backward, AdamW over the module's parameters): no copy, no gather and
    no extra op."""
    jinit = jax_run("contrastive", (4, 2))[0]
    cfg = BertConfig(dtype=torch.float32, **TINY)
    params = bert_params_from_jax(jinit)
    state = ttrain.make_train_state(cfg, port_mesh((1, 1)), LR, init_params_tree=params)
    step, place = ttrain.contrastive_train_step(state.mesh)
    model = BertEncoder(cfg)
    model.load_state_dict(params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(ttrain.ADAM_B1, ttrain.ADAM_B2),
                            eps=ttrain.ADAM_EPS, weight_decay=ttrain.WEIGHT_DECAY)
    rows = place(make_batch(7, "contrastive"))
    (batch,) = rows

    def embed(side):
        mask = batch[f"{side}_mask"]
        return l2_normalize(mean_pool(model(batch[f"{side}_ids"], mask), mask))

    runs = []
    for i in range(2):  # the second step: the moments exist
        with _Ops() as mine:
            state, met = step(state, rows)
        with _Ops() as plain:  # the single-device step's body
            opt.zero_grad(set_to_none=True)
            loss, metrics = ttrain._info_nce(embed("q"), embed("d"), embed("n"), 0.05)
            loss.backward()
            opt.step()
            metrics = {k: v.detach() for k, v in metrics.items()}
        runs.append((mine.ops, plain.ops))
        assert met["loss"].item() == metrics["loss"].item()
    assert runs[1][0] == runs[1][1] and len(runs[1][0]) > 100


def test_step_refuses_a_state_of_another_mesh():
    jinit = jax_run("contrastive", (4, 2))[0]
    state = port_run("contrastive", (2, 1), jinit)[0]
    step, place = ttrain.contrastive_train_step(port_mesh((1, 2)))
    with pytest.raises(ValueError, match="mesh"):
        step(state, place(make_batch(1, "contrastive")))
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.contrastive_train_step(port_mesh((8, 1)))[1](
            {k: v[:6] for k, v in make_batch(1, "contrastive", hard=False).items()})
    with pytest.raises(ValueError, match="not both"):
        ttrain.train_mesh(port_mesh((1, 1)), "cpu")
