"""The trainers on a mesh: `train_embedder` / `train_cross_encoder` /
`RadiantTPU.train` round the batch to the data axis as the JAX package's
do and draw equal batches; `mesh=None` is `create_mesh()`. The JAX side
on the conftest's 8 virtual CPU devices, the port on logical `cpu` shards
(tests/_torch_parallel_world.py).

Tolerance of the trainers' metrics (float32, several AdamW steps), as
tests/test_torch_train_data.py's: rtol 1e-4 / atol 1e-5 on the loss,
accuracy equal; the batches equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiant_rag_tpu.config import EmbeddingConfig as JaxEmbConfig
from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.models.bert import init_params as jax_init_params
from radiant_rag_tpu.models.cross_encoder import CrossEncoderModel as JaxCEModel
from radiant_rag_tpu.models.tokenizer import load_tokenizer as jax_tokenizer
from radiant_rag_tpu.parallel import data as jdata
from radiant_rag_tpu.parallel.mesh import create_mesh as jax_mesh
from radiant_rag_tpu_torch.config import EmbeddingConfig
from radiant_rag_tpu_torch.convert import bert_params_from_jax, cross_encoder_params_from_jax
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.models.tokenizer import load_tokenizer
from radiant_rag_tpu_torch.parallel import data as tdata
from radiant_rag_tpu_torch.parallel import train as ttrain

from _torch_app_world import make_apps, write_docs
from _torch_parallel_world import TINY, np_tree, port_mesh

VOCAB = 300
EMB = dict(dim=16, num_layers=1, num_heads=2, hidden_dim=32, vocab_size=VOCAB, max_seq_len=32,
           batch_size=8, dtype="float32", checkpoint_dir="")
TRAIN_LOSS = dict(rtol=1e-4, atol=1e-5)


def _texts(n=40, seed=5):
    rng = np.random.default_rng(seed)
    words = sorted(tdata.SYNONYMS)[:60] + [f"w{i}" for i in range(100)]
    return [". ".join(" ".join(rng.choice(words, int(rng.integers(4, 10))))
                      for _ in range(int(rng.integers(2, 4)))) + "." for _ in range(n)]


def _recording(sampler, out):
    """Record every batch the trainer draws from `sampler`."""
    draw = sampler.next_batch

    def next_batch():
        batch = draw()
        out.append(batch)
        return batch

    sampler.next_batch = next_batch
    return sampler


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in r:
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)


@pytest.mark.parametrize("batch_size,data", [(6, 4), (8, 8)])
def test_train_embedder_rounds_the_batch_to_the_data_axis_as_jax(batch_size, data):
    """A caller's sampler at batch 6 on a data axis of 4 draws batches of
    8 in both packages (8 on 8 stays), the same batches, and the runs
    agree."""
    texts = _texts()
    init = np_tree(jax_init_params(JaxBertConfig(
        vocab_size=VOCAB, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
        dtype=jnp.float32), seed=0))
    kw = dict(steps=3, batch_size=batch_size, learning_rate=1e-3, log_every=1, seed=1)
    drawn = {"j": [], "t": []}
    jsampler = _recording(jdata.ContrastivePairSampler(
        texts, jax_tokenizer("", VOCAB), batch_size=batch_size, max_seq_len=32, seed=1),
        drawn["j"])
    tsampler = _recording(tdata.ContrastivePairSampler(
        texts, load_tokenizer("", VOCAB), batch_size=batch_size, max_seq_len=32, seed=1),
        drawn["t"])
    ref = jdata.train_embedder(None, JaxEmbConfig(preset="none", **EMB),
                               mesh=jax_mesh(data=data, model=1), sampler=jsampler,
                               init_params_tree=init, **kw)
    got = tdata.train_embedder(None, EmbeddingConfig(preset="none", **EMB),
                               mesh=port_mesh((data, 1)), sampler=tsampler,
                               init_params_tree=bert_params_from_jax(init), **kw)
    want = -(-batch_size // data) * data
    assert jsampler.batch_size == tsampler.batch_size == want
    assert all(b["q_ids"].shape[0] == want for b in drawn["t"])
    _assert_batches_equal(drawn["t"], drawn["j"])
    np.testing.assert_allclose(got["loss"], ref["loss"], **TRAIN_LOSS)
    assert (got["accuracy"], got["steps_run"]) == (ref["accuracy"], ref["steps_run"])


def test_train_cross_encoder_rounds_the_groups_to_the_data_axis_as_jax(monkeypatch):
    """3 groups of 4 on a data axis of 8 become 4 groups (16 pairs, two
    a data shard: a group straddles two shards) in both packages; equal
    batches, equal runs."""
    texts = _texts(seed=6)
    cfg = JaxBertConfig(vocab_size=VOCAB, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, dtype=jnp.float32)
    dummy = jnp.zeros((1, 8), jnp.int32)
    init = np_tree(JaxCEModel(cfg).init(jax.random.PRNGKey(2), dummy,
                                        jnp.ones((1, 8), jnp.int32), dummy))
    kw = dict(steps=3, batch_size=12, learning_rate=1e-3, log_every=1, seed=2)
    drawn = {"j": [], "t": []}
    samplers = {}
    for key, mod, tok in (("j", jdata, jax_tokenizer), ("t", tdata, load_tokenizer)):
        samplers[key] = _recording(mod.CrossEncoderPairSampler(
            texts, tok("", VOCAB), batch_size=12, max_seq_len=40, seed=2, n_hard_negatives=0,
            n_random_negatives=3), drawn[key])
    ref = jdata.train_cross_encoder(texts, bert_cfg=cfg, mesh=jax_mesh(data=8, model=1),
                                    sampler=samplers["j"], **kw)
    make = ttrain.make_ce_train_state
    monkeypatch.setattr(ttrain, "make_ce_train_state", lambda *a, **k: make(
        *a, init_params_tree=cross_encoder_params_from_jax(init), **k))
    got = tdata.train_cross_encoder(
        texts, bert_cfg=BertConfig(vocab_size=VOCAB, hidden_size=16, num_layers=1, num_heads=2,
                                   intermediate_size=32, dtype=torch.float32),
        mesh=port_mesh((8, 1)), sampler=samplers["t"], **kw)
    assert samplers["j"].n_groups == samplers["t"].n_groups == 4
    assert all(b["ids"].shape[0] == 16 for b in drawn["t"])
    _assert_batches_equal(drawn["t"], drawn["j"])
    np.testing.assert_allclose(got["loss"], ref["loss"], **TRAIN_LOSS)
    assert (got["accuracy"], got["steps_run"]) == (ref["accuracy"], ref["steps_run"])


def _mesh_of_every_device(monkeypatch, shape):
    """`create_mesh()` (every visible CUDA device on 'data') as logical cpu
    shards; returns the list of meshes it built."""
    built = []
    real = ttrain.create_mesh

    def create_mesh(data=-1, model=1, devices=None):
        if devices is not None:
            return real(data, model, devices)
        built.append(port_mesh(shape))
        return built[-1]

    monkeypatch.setattr(ttrain, "create_mesh", create_mesh)
    return built


def test_trainers_without_a_mesh_take_create_mesh(monkeypatch):
    """mesh=None and device=None: `create_mesh()`, whose data axis then
    rounds the batch; a named device is its 1 x 1 mesh; both raise."""
    built = _mesh_of_every_device(monkeypatch, (4, 1))
    texts = _texts()
    sampler = tdata.ContrastivePairSampler(texts, load_tokenizer("", VOCAB), batch_size=5,
                                           max_seq_len=32, seed=1)
    tdata.train_embedder(None, EmbeddingConfig(preset="none", **EMB), steps=2, batch_size=5,
                         sampler=sampler)
    assert len(built) == 1 and sampler.batch_size == 8
    tdata.train_embedder(None, EmbeddingConfig(preset="none", **EMB), steps=2, batch_size=5,
                         sampler=sampler, device="cpu")
    assert len(built) == 1 and sampler.batch_size == 5
    with pytest.raises(ValueError, match="not both"):
        tdata.train_cross_encoder(texts, bert_cfg=BertConfig(**TINY), steps=2,
                                  mesh=port_mesh((1, 1)), device="cpu")


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_apps")
    japp, tapp_ = make_apps(tmp)
    docs = write_docs(tmp / "docs", n_files=4)
    japp.ingest_documents([str(docs)])
    tapp_.ingest_documents([str(docs)])
    return japp, tapp_, tmp


def test_app_train_takes_create_mesh_unless_built_on_a_named_device(apps, monkeypatch):
    """The JAX app trains on its default mesh, every device on 'data' (the
    rounding is the one test_train_embedder_rounds_the_batch_... holds);
    the port's app built without a device trains on `create_mesh()` (here
    8 logical cpu shards: a batch of 6 becomes 8), built on a named
    device, on that device's 1 x 1 mesh (6 stays)."""
    japp, app, tmp = apps
    built = _mesh_of_every_device(monkeypatch, (8, 1))
    shapes = []
    draw = tdata.ContrastivePairSampler.next_batch

    def next_batch(sampler):
        out = draw(sampler)
        shapes.append(out["q_ids"].shape[0])
        return out

    monkeypatch.setattr(tdata.ContrastivePairSampler, "next_batch", next_batch)
    monkeypatch.setattr(app, "_named_device", False)
    metrics = app.train(steps=2, batch_size=6, checkpoint_dir=str(tmp / "ck_t"),
                        hard_negatives=2)
    assert shapes == [8, 8] and len(built) == 1
    assert metrics["steps_run"] == 2 and np.isfinite(metrics["loss"])
    monkeypatch.setattr(app, "_named_device", True)
    app.train(steps=2, batch_size=6, checkpoint_dir=str(tmp / "ck_t1"), hard_negatives=2)
    assert shapes[2:] == [6, 6] and len(built) == 1
