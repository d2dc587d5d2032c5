"""Training data and the training entry points: the port's pair samplers,
query augmentations, `train_embedder`, `train_cross_encoder`,
`RadiantTPU.train` and the `train` CLI against the JAX package's on the CPU.

Both packages sample from equal stores (the same upserts), BM25 indexes
built from the same texts and the same seed, so their batches must be
equal exactly (ids, masks, type ids, labels, hard negatives). The JAX
trainers run on a one-device mesh (data = 1, model = 1), the port's one
device, from the same init. Tolerance of the trained metrics (float32,
several AdamW steps): rtol 1e-4 / atol 1e-5 on the loss; accuracy and the
auto-stop bookkeeping (steps_run, stop_reason, accuracy_ema) equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiant_rag_tpu.config import EmbeddingConfig as JaxEmbConfig
from radiant_rag_tpu.config import IndexConfig as JaxIndexConfig
from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.models.bert import init_params as jax_init_params
from radiant_rag_tpu.models.cross_encoder import CrossEncoderModel as JaxCEModel
from radiant_rag_tpu.models.tokenizer import load_tokenizer as jax_tokenizer
from radiant_rag_tpu.parallel import data as jdata
from radiant_rag_tpu.parallel.checkpoint import TrainCheckpointer as JaxCheckpointer
from radiant_rag_tpu.parallel.mesh import create_mesh
from radiant_rag_tpu_torch import app as tapp
from radiant_rag_tpu_torch.app import RadiantTPU
from radiant_rag_tpu_torch.config import EmbeddingConfig, IndexConfig
from radiant_rag_tpu_torch.convert import bert_params_from_jax, cross_encoder_params_from_jax
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.store import TpuVectorStore
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.models.tokenizer import load_tokenizer
from radiant_rag_tpu_torch.parallel import data as tdata
from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

from _torch_app_world import make_apps, write_docs

VOCAB = 300
EMB = dict(dim=16, num_layers=1, num_heads=2, hidden_dim=32, vocab_size=VOCAB, max_seq_len=32,
           batch_size=8, dtype="float32", checkpoint_dir="")
LOSS = dict(rtol=1e-4, atol=1e-5)
N_DOCS = 48


def _texts(n=N_DOCS, seed=5):
    """Zipfian word texts with sentences, so the pseudo-queries take both
    branches (lead sentence, random window) and the synonyms fire."""
    rng = np.random.default_rng(seed)
    words = sorted(tdata.SYNONYMS)[:60] + [f"w{i}" for i in range(200)]
    out = []
    for i in range(n):
        toks = [words[z % len(words)] for z in rng.zipf(1.2, 30)]
        out.append(f"Record {i} " + " ".join(toks[:12]) + ". " + " ".join(toks[12:]) + ".")
    return out


@pytest.fixture(scope="module")
def world():
    """Equal stores and BM25 indexes in both packages over the same texts."""
    texts = _texts()
    r = np.random.default_rng(0)
    docs = [(t, {"n": i}, r.standard_normal(16).astype(np.float32)) for i, t in enumerate(texts)]
    jstore = JaxStore(dim=16, index_config=JaxIndexConfig(dim=16, initial_capacity=64))
    tstore = TpuVectorStore(dim=16, index_config=IndexConfig(dim=16, initial_capacity=64),
                            device="cpu")
    jstore.upsert_batch(docs)
    tstore.upsert_batch(docs)
    ids = jstore.list_doc_ids_with_embeddings()
    assert ids == tstore.list_doc_ids_with_embeddings()
    rows = [jstore.row_of(i) for i in ids]
    assert rows == [tstore.row_of(i) for i in ids]
    contents = [jstore.get_doc(i).content for i in ids]
    jbm, tbm = JaxBM25(sketch_dim=128), BM25Index(sketch_dim=128, device="cpu")
    jbm.bulk_build(rows, contents)
    tbm.bulk_build(rows, contents)
    return {"texts": texts, "rows": rows, "contents": contents, "j": (jstore, jbm),
            "t": (tstore, tbm)}


def _assert_batches_equal(jsampler, tsampler, n=3):
    for i in range(n):
        ref, got = jsampler.next_batch(), tsampler.next_batch()
        assert set(got) == set(ref), i
        for key in ref:
            assert got[key].dtype == ref[key].dtype, (i, key)
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"batch {i} {key}")


AUGMENT = {"none": (None, None), "synonym": (jdata.synonym_augment, tdata.synonym_augment),
           "paraphrase": (jdata.paraphrase_augment, tdata.paraphrase_augment)}


@pytest.mark.parametrize("hard,augment,batch_size", [
    (0, "none", 8), (2, "none", 8), (2, "paraphrase", 16), (1, "synonym", 8),
    (2, "none", 64),  # more than the corpus: sampled with replacement
])
def test_contrastive_sampler_batches_equal_jax(world, hard, augment, batch_size):
    """from_store over equal stores and BM25 indexes: q / d / n ids and
    masks padded to one shared length, the same arrays batch after batch
    (the mined negatives and the random fill included)."""
    jaug, taug = AUGMENT[augment]
    kw = dict(batch_size=batch_size, max_seq_len=32, seed=7, n_hard_negatives=hard)
    js = jdata.ContrastivePairSampler.from_store(
        world["j"][0], jax_tokenizer("", VOCAB), bm25=world["j"][1] if hard else None,
        query_augment=jaug, **kw)
    ts = tdata.ContrastivePairSampler.from_store(
        world["t"][0], load_tokenizer("", VOCAB), bm25=world["t"][1] if hard else None,
        query_augment=taug, **kw)
    assert ts._replace == js._replace == (batch_size > N_DOCS)
    _assert_batches_equal(js, ts)
    batch = ts.next_batch()
    if hard:
        assert batch["n_ids"].shape == (batch_size * hard, batch["q_ids"].shape[1])


@pytest.mark.parametrize("hard,rand,paraphrase", [(2, 1, 0.5), (0, 3, 0.0), (3, 0, 1.0)])
def test_cross_encoder_sampler_batches_equal_jax(world, hard, rand, paraphrase):
    """Groups of 1 positive + hard + random negatives (positive first), the
    batch floored to whole groups: ids, masks, type ids and labels equal."""
    kw = dict(batch_size=18, max_seq_len=48, seed=11, rows=world["rows"], n_hard_negatives=hard,
              n_random_negatives=rand, paraphrase_fraction=paraphrase)
    js = jdata.CrossEncoderPairSampler(world["contents"], jax_tokenizer("", VOCAB),
                                       bm25=world["j"][1] if hard else None, **kw)
    ts = tdata.CrossEncoderPairSampler(world["contents"], load_tokenizer("", VOCAB),
                                       bm25=world["t"][1] if hard else None, **kw)
    assert (ts.group, ts.n_groups, ts.batch_size) == (js.group, js.n_groups, js.batch_size)
    _assert_batches_equal(js, ts)
    labels = ts.next_batch()["labels"].reshape(-1, ts.group)
    assert (labels[:, 0] == 1).all() and labels[:, 1:].sum() == 0


@pytest.mark.parametrize("name", ["synonym_augment", "paraphrase_augment"])
def test_augmentations_equal_jax(name):
    texts = _texts(60, seed=9)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    jfn, tfn = getattr(jdata, name), getattr(tdata, name)
    for t in texts:
        q = " ".join(t.split()[:12])
        assert tfn(q, tr) == jfn(q, jr)
    assert tdata.SYNONYMS == jdata.SYNONYMS and tdata.STOPWORDS == jdata.STOPWORDS


def _bert_init():
    return jax_init_params(JaxBertConfig(vocab_size=VOCAB, hidden_size=16, num_layers=1,
                                         num_heads=2, intermediate_size=32,
                                         dtype=jnp.float32), seed=0)


@pytest.mark.parametrize("auto_stop", [False, True])
def test_train_embedder_matches_jax(world, tmp_path, auto_stop):
    """train_embedder end to end from the same init, store and BM25 index:
    metric keys, loss, accuracy, steps_run / stop_reason / accuracy_ema,
    and a checkpoint at the last step in both packages."""
    init = jax.tree.map(np.asarray, _bert_init())
    kw = dict(steps=30 if auto_stop else 4, batch_size=8, learning_rate=1e-3, log_every=2,
              hard_negatives=2, seed=1, auto_stop=auto_stop, min_steps=6, plateau_window=4,
              plateau_eps=0.01, query_augment=None)
    ref = jdata.train_embedder(world["j"][0], JaxEmbConfig(preset="none", **EMB),
                               mesh=create_mesh(data=1, model=1), bm25=world["j"][1],
                               checkpoint_dir=str(tmp_path / "j"), init_params_tree=init, **kw)
    got, params = tdata.train_embedder(world["t"][0], EmbeddingConfig(preset="none", **EMB),
                                       device="cpu", bm25=world["t"][1],
                                       checkpoint_dir=str(tmp_path / "t"), return_params=True,
                                       init_params_tree=bert_params_from_jax(init), **kw)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["loss"], ref["loss"], **LOSS)
    for key in set(ref) - {"loss"}:
        assert got[key] == ref[key], key
    steps = ref["steps_run"]
    if auto_stop:
        assert ref["stop_reason"] == "accuracy_plateau" and steps < 30
    assert TrainCheckpointer(str(tmp_path / "t")).latest_step() == steps
    assert JaxCheckpointer(str(tmp_path / "j")).latest_step() == steps
    saved = TrainCheckpointer(str(tmp_path / "t")).restore(template=None)
    assert saved["opt_state"]["count"] == steps
    assert set(params) == set(bert_params_from_jax(init))


def test_train_cross_encoder_matches_jax(world, monkeypatch):
    """train_cross_encoder end to end (listwise, 2 hard + 1 random) from
    the JAX package's own init of the same seed (the port's train state
    is built from it: its own init draws from another generator)."""
    from radiant_rag_tpu_torch.parallel import train as ttrain

    cfg = JaxBertConfig(vocab_size=VOCAB, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, dtype=jnp.float32)
    dummy = jnp.zeros((1, 8), jnp.int32)
    init = jax.tree.map(np.asarray, JaxCEModel(cfg).init(jax.random.PRNGKey(2), dummy,
                                                          jnp.ones((1, 8), jnp.int32), dummy))
    kw = dict(steps=4, batch_size=16, learning_rate=1e-3, max_seq_len=48, log_every=1, seed=2,
              rows=world["rows"], hard_negatives=2, random_negatives=1)
    ref, jparams = jdata.train_cross_encoder(world["contents"], bert_cfg=cfg,
                                             mesh=create_mesh(data=1, model=1),
                                             bm25=world["j"][1], return_params=True, **kw)
    make = ttrain.make_ce_train_state
    monkeypatch.setattr(ttrain, "make_ce_train_state", lambda *a, **k: make(
        *a, init_params_tree=cross_encoder_params_from_jax(init), **k))
    got = tdata.train_cross_encoder(
        world["contents"], device="cpu", bm25=world["t"][1],
        bert_cfg=BertConfig(vocab_size=VOCAB, hidden_size=16, num_layers=1, num_heads=2,
                            intermediate_size=32, dtype=torch.float32), **kw)
    assert set(got) == set(ref) == {"loss", "accuracy", "steps_run"}
    np.testing.assert_allclose(got["loss"], ref["loss"], **LOSS)
    assert (got["accuracy"], got["steps_run"]) == (ref["accuracy"], ref["steps_run"])


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_apps")
    japp, tapp_ = make_apps(tmp)
    docs = write_docs(tmp / "docs", n_files=4)
    japp.ingest_documents([str(docs)])
    tapp_.ingest_documents([str(docs)])
    return japp, tapp_, tmp


def test_app_train_swaps_params_and_clears_caches(apps, monkeypatch):
    """RadiantTPU.train as the JAX app's: the serving encoder's params are
    the trained ones, both caches are cleared, the fusion calibration
    runs again at the next search, the checkpoint is the swapped params;
    each mining search and step and the swap hold the device lock."""
    japp, app, tmp = apps
    out = {}
    for key, a in (("j", japp), ("t", app)):
        a.search("solar panel energy")  # calibrates, fills both caches
        hy = a.orchestrator._hybrid
        assert not hy.needs_calibration() and len(a.query_cache._data) > 0
        before = ({k: v.clone() for k, v in a.local_models.embedder.model.state_dict().items()}
                  if key == "t" else None)
        metrics = a.train(steps=3, batch_size=8, learning_rate=1e-3,
                          checkpoint_dir=str(tmp / f"ck_{key}"), hard_negatives=2)
        assert len(a.query_cache._data) == 0 and a.local_models.embedder.cache.stats()["size"] == 0
        assert hy.needs_calibration()
        out[key] = (metrics, before)
    assert set(out["t"][0]) == set(out["j"][0]) == {"loss", "accuracy", "steps_run"}
    assert out["t"][0]["steps_run"] == out["j"][0]["steps_run"] == 3
    served = app.local_models.embedder.model.state_dict()
    assert any(not torch.equal(served[k], v) for k, v in out["t"][1].items())
    from radiant_rag_tpu_torch.models.embedder import Embedder

    fresh = Embedder(dataclasses.replace(app.config.embedding, checkpoint_dir=str(tmp / "ck_t")),
                     device="cpu")
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, served[k]), k
    q = "wind turbine battery"
    np.testing.assert_array_equal(app.local_models.embed([q]), fresh.embed([q]))
    held = []
    lock = app.device_lock

    class Spy:
        def __enter__(self):
            held.append(lock._is_owned())
            return lock.__enter__()

        def __exit__(self, *exc):
            return lock.__exit__(*exc)

    monkeypatch.setattr(app, "device_lock", Spy())
    app.train(steps=2, batch_size=8, checkpoint_dir=str(tmp / "ck_t2"), hard_negatives=2)
    assert held == [False] * (2 + 2 + 1)  # 2 mining searches, 2 steps, the swap; none nested
    app.search("solar panel energy")
    assert not app.orchestrator._hybrid.needs_calibration()


@pytest.mark.parametrize("auto", [False, True])
def test_app_train_recipe_reaches_train_embedder(apps, monkeypatch, auto):
    """The arguments app.train hands train_embedder, the `auto` recipe's
    overrides included, equal the JAX app's (both monkeypatched)."""
    japp, app, tmp = apps
    calls = {}

    def fake(key, params):
        def train_embedder(store, cfg, **kw):
            calls[key] = kw
            return {"loss": 0.0, "accuracy": 1.0, "steps_run": kw["steps"]}, params
        return train_embedder

    monkeypatch.setattr(jdata, "train_embedder", fake("j", japp.local_models.embedder.params))
    monkeypatch.setattr(tdata, "train_embedder",
                        fake("t", app.local_models.embedder.model.state_dict()))
    for key, a in (("j", japp), ("t", app)):
        a.train(steps=50, batch_size=16, learning_rate=3e-5, checkpoint_dir="ck",
                hard_negatives=1, auto=auto)
    j, t = calls["j"], calls["t"]
    assert t.pop("device") == app.device and t.pop("device_lock") is app.device_lock
    assert t.pop("bm25") is app.bm25_index.index and j.pop("bm25") is japp.bm25_index.index
    jaug, taug = j.pop("query_augment"), t.pop("query_augment")
    assert (jaug, taug) == ((jdata.paraphrase_augment, tdata.paraphrase_augment) if auto
                            else (None, None))
    assert t == j
    if auto:
        assert (t["steps"], t["batch_size"], t["learning_rate"], t["hard_negatives"],
                t["min_steps"], t["plateau_window"], t["plateau_eps"], t["auto_stop"]) == \
            (12000, 256, 1e-4, 2, 5000, 2500, 0.005, True)


def test_cli_train_prints_the_metrics_json(tmp_path, monkeypatch, capsys):
    """`train` on the CLI (configured by RADIANT_* overrides) trains, writes
    the checkpoint to embedding.checkpoint_dir and prints the metrics."""
    monkeypatch.setenv("RADIANT_INDEX_DATA_DIR", str(tmp_path / "idx"))
    monkeypatch.setenv("RADIANT_BM25_INDEX_PATH", str(tmp_path / "bm25.json.gz"))
    monkeypatch.setenv("RADIANT_EMBEDDING_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("RADIANT_EMBEDDING_BATCH_SIZE", "16")
    monkeypatch.setenv("RADIANT_LOGGING_COLOR", "false")
    apps_made = []

    def create_app(config):
        apps_made.append(RadiantTPU(config, device="cpu"))
        return apps_made[-1]

    monkeypatch.setattr(tapp, "create_app", create_app)
    assert tapp.main(["ingest", str(write_docs(tmp_path / "docs", n_files=2))]) == 0
    capsys.readouterr()
    assert tapp.main(["train", "--steps", "2", "--batch-size", "4", "--lr", "1e-4",
                      "--hard-negatives", "1"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == {"loss", "accuracy", "steps_run"} and metrics["steps_run"] == 2
    assert np.isfinite(metrics["loss"])
    assert TrainCheckpointer(str(tmp_path / "ckpt")).latest_step() == 2
