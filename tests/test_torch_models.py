"""The models slice: the port's BERT encoder, embedder, cross-encoder and
weight loaders against the JAX package's on the same inputs (CPU).

Weights are carried across with `convert.bert_params_from_jax` /
`cross_encoder_params_from_jax`; inputs are made from a seed with numpy.

Tolerance:
  * float32 (`dtype: float32`): rtol 1e-5 / atol 1e-5, the room the two
    frameworks' float32 summation orders need;
  * bfloat16: |port - jax| <= 2^-5 + 2^-7 |jax| elementwise (two bf16 ulps
    at |x| < 4 plus two relative ulps) and a mean within 2^-7. The port
    rounds where flax's written semantics round; XLA's jit on the CPU keeps
    some of those intermediates in float32, and XLA's bf16 `erfc` differs
    from torch's `erf` GELU by one ulp, so the two cannot agree bit for bit
    (measured: 2 ulps at most through 2 layers, 3 through 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiant_rag_tpu.config import CrossEncoderConfig as JaxCEConfig
from radiant_rag_tpu.config import EmbeddingConfig as JaxEmbConfig
from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.models.bert import BertEncoder as JaxBertEncoder
from radiant_rag_tpu.models.bert import init_params as jax_init_params
from radiant_rag_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from radiant_rag_tpu.models.cross_encoder import CrossEncoderModel as JaxCEModel
from radiant_rag_tpu.models.embedder import Embedder as JaxEmbedder
from radiant_rag_tpu_torch.config import CrossEncoderConfig, EmbeddingConfig, config_from_dict
from radiant_rag_tpu_torch.convert import bert_params_from_jax, cross_encoder_params_from_jax
from radiant_rag_tpu_torch.models import pretrained
from radiant_rag_tpu_torch.models.bert import BertConfig, BertEncoder, init_params
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder, CrossEncoderModel
from radiant_rag_tpu_torch.models.embedder import Embedder
from radiant_rag_tpu_torch.models.registry import LocalNLPModels

F32 = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TEXTS = [f"document number {i} about retrieval topic {i % 5} with extra detail token{i}"
         for i in range(20)] + ["café résumé naïve", "", "Hello, WORLD!! 42"]


def assert_close(got, ref, dtype, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, err_msg=what, **F32)
        return
    err = np.abs(got - ref)
    assert (err <= 2.0 ** -5 + 2.0 ** -7 * np.abs(ref)).all(), (what, err.max())
    assert err.mean() <= 2.0 ** -7, (what, err.mean())


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed, b=5, s=16, vocab=300):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, 9:] = 0
    mask[2, 4:] = 0
    types = np.zeros((b, s), np.int32)
    types[:, 7:] = 1
    return ids, mask, types


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_encoder_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = JaxBertConfig(dtype=jdt, **SMALL)
    params = jax_init_params(jcfg, seed=1)
    model = BertEncoder(BertConfig(dtype=tdt, **SMALL))
    model.load_state_dict(bert_params_from_jax(_numpy(params)))
    ids, mask, types = _inputs(2)
    ref = jax.jit(JaxBertEncoder(jcfg).apply)(params, ids, mask, types)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    assert got.dtype == tdt
    live = mask.astype(bool)  # pad positions are never read downstream
    assert_close(got.float().numpy()[live], np.asarray(ref.astype(jnp.float32))[live], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encoder_model_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    ids, mask, types = _inputs(3)
    jmodel = JaxCEModel(JaxBertConfig(dtype=jdt, **SMALL))
    params = jmodel.init(jax.random.PRNGKey(3), ids, mask, types)
    model = CrossEncoderModel(BertConfig(dtype=tdt, **SMALL))
    model.load_state_dict(cross_encoder_params_from_jax(_numpy(params)))
    ref = np.asarray(jax.jit(jmodel.apply)(params, ids, mask, types))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), ref, dtype)


def test_convert_names_every_leaf_and_transposes_kernels():
    params = _numpy(jax_init_params(JaxBertConfig(**SMALL), seed=4))["params"]
    sd = bert_params_from_jax({"params": params})
    assert set(sd) == set(BertEncoder(BertConfig(**SMALL)).state_dict())
    np.testing.assert_array_equal(sd["layer_1.mlp_in.weight"].numpy(),
                                  params["layer_1"]["mlp_in"]["kernel"].T)
    np.testing.assert_array_equal(sd["emb_ln.weight"].numpy(), params["emb_ln"]["scale"])
    with pytest.raises(ValueError):
        cross_encoder_params_from_jax({"params": params})


def _embedders(dtype, **overrides):
    fields = {**dict(preset="none", dim=32, num_layers=2, num_heads=4, hidden_dim=64,
                     vocab_size=300, max_seq_len=32, batch_size=8, dtype=dtype,
                     checkpoint_dir=""), **overrides}
    jemb = JaxEmbedder(JaxEmbConfig(**fields), seed=5)
    temb = Embedder(EmbeddingConfig(**fields), params=bert_params_from_jax(_numpy(jemb.params)),
                    device="cpu")
    return jemb, temb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedder_embed_and_embed_device_match_jax(dtype):
    jemb, temb = _embedders(dtype)
    ref = jemb.embed(TEXTS)
    got = temb.embed(TEXTS)
    assert got.shape == (len(TEXTS), 32) and got.dtype == np.float32
    assert_close(got, ref, dtype, "embed")
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    dev = temb.embed_device(TEXTS[:5], pad_to=8)
    ref_dev = np.asarray(jemb.embed_device(TEXTS[:5], pad_to=8))
    assert isinstance(dev, torch.Tensor) and dev.shape == (8, 32) and dev.dtype == torch.float32
    assert_close(dev.numpy(), ref_dev, dtype, "embed_device")
    assert (dev[5:] == 0).all(), "padded rows are exactly zero"
    with pytest.raises(ValueError, match="pad_to"):
        temb.embed_device(TEXTS[:5], pad_to=4)


def test_embedder_batching_and_cache():
    _, temb = _embedders("float32", batch_size=4)  # 23 texts: 5 batches, the last padded
    whole = temb.embed(TEXTS)
    assert temb.cache.stats()["misses"] == len(TEXTS)
    again = temb.embed(TEXTS[::-1])
    np.testing.assert_array_equal(again, whole[::-1])
    assert temb.cache.hits == len(TEXTS)
    single = temb.embed_single(TEXTS[3])
    np.testing.assert_array_equal(single, whole[3])
    temb.set_params(init_params(temb.bert_cfg, seed=9))
    assert temb.cache.stats()["size"] == 0
    assert not np.allclose(temb.embed([TEXTS[3]])[0], whole[3])
    assert temb.embed([]).shape == (0, 32)


@pytest.mark.parametrize("case", ["empty", "foreign step", "port step", "other shapes",
                                  "explicit params"])
def test_embedder_refuses_a_checkpoint_it_cannot_restore(tmp_path, case):
    """checkpoint_dir: an empty directory is ignored; a port checkpoint
    (`parallel/checkpoint.py`) is restored; a step directory the port did
    not write (an orbax one of the JAX package) raises NotImplementedError
    naming the conversion; a checkpoint of other shapes raises; explicit
    params win, as in the JAX package."""
    from radiant_rag_tpu_torch.convert import params_to_flat
    from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

    ckpt = tmp_path / "embedder_ckpt"
    ckpt.mkdir()
    cfg = EmbeddingConfig(preset="none", dim=32, num_layers=1, num_heads=4, hidden_dim=64,
                          vocab_size=300, checkpoint_dir=str(ckpt))
    one = BertConfig(**{**SMALL, "num_layers": 1})
    trained = init_params(one, seed=5)
    if case == "empty":
        emb = Embedder(cfg, device="cpu")  # an empty directory holds nothing to serve
        assert not torch.equal(emb.model.state_dict()["word_emb.weight"],
                               trained["word_emb.weight"])
    elif case == "foreign step":
        (ckpt / "0").mkdir()
        with pytest.raises(NotImplementedError, match="embedder_checkpoint_from_jax"):
            Embedder(cfg, device="cpu")
    elif case in ("port step", "explicit params"):
        TrainCheckpointer(str(ckpt)).save_arrays(7, params_to_flat(BertEncoder(one), trained))
        explicit = init_params(one, seed=0) if case == "explicit params" else None
        emb = Embedder(cfg, params=explicit, device="cpu")
        want = explicit if explicit is not None else trained
        for key, value in want.items():
            assert torch.equal(emb.model.state_dict()[key], value), key
    else:
        wide = BertConfig(**{**SMALL, "num_layers": 1, "intermediate_size": 48})
        TrainCheckpointer(str(ckpt)).save_arrays(
            3, params_to_flat(BertEncoder(wide), init_params(wide, seed=5)))
        with pytest.raises(ValueError, match="does not fit"):
            Embedder(cfg, device="cpu")


def _cross_encoders(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = dict(max_seq_len=40, batch_size=4, dtype=dtype)
    jce = JaxCrossEncoder(JaxCEConfig(**cfg), bert_cfg=JaxBertConfig(dtype=jdt, **SMALL), seed=3)
    tce = CrossEncoder(CrossEncoderConfig(**cfg), bert_cfg=BertConfig(dtype=tdt, **SMALL),
                       params=cross_encoder_params_from_jax(_numpy(jce.params)), device="cpu")
    return jce, tce


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encoder_score_pairs_and_rerank_match_jax(dtype):
    jce, tce = _cross_encoders(dtype)
    pairs = [(f"retrieval topic {i % 3}", TEXTS[i]) for i in range(len(TEXTS))]
    assert_close(tce.score_pairs(pairs), jce.score_pairs(pairs), dtype, "score_pairs")
    assert tce.score_pairs([]).shape == (0,)
    if dtype == "float32":
        docs = TEXTS[:9]
        ref, got = jce.rerank("topic 2 detail", docs, top_k=5), tce.rerank("topic 2 detail", docs,
                                                                            top_k=5)
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], **F32)


def test_shipped_artifacts_match_jax_in_f32():
    """The 128 x 6 bi-encoder and cross-encoder the JAX package ships,
    loaded by path under the trainable-small preset at float32."""
    cfg = config_from_dict({"embedding": {"dtype": "float32", "checkpoint_dir": ""},
                            "cross_encoder": {"dtype": "float32"}})
    e, c = cfg.embedding, cfg.cross_encoder
    assert (e.dim, e.num_layers, c.dim, c.num_layers) == (128, 6, 128, 6)
    temb = Embedder(e, device="cpu")
    jfields = {f: getattr(e, f) for f in ("dim", "num_layers", "num_heads", "hidden_dim",
                                          "vocab_size", "max_seq_len", "dtype")}
    jemb = JaxEmbedder(JaxEmbConfig(preset="none", checkpoint_dir="", **jfields))
    z = np.load(pretrained.PRETRAINED_DIR / "embedder_128x6.npz")
    np.testing.assert_array_equal(temb.model.state_dict()["layer_5.mlp_out.weight"].numpy(),
                                  z["params/layer_5/mlp_out/kernel"].T)
    np.testing.assert_allclose(temb.embed(TEXTS), jemb.embed(TEXTS), **F32)
    tce = CrossEncoder(c, device="cpu")
    jce = JaxCrossEncoder(JaxCEConfig(**{f: getattr(c, f) for f in (
        "dim", "num_layers", "num_heads", "hidden_dim", "vocab_size", "max_seq_len", "dtype")}))
    pairs = [("retrieval topic", t) for t in TEXTS]
    np.testing.assert_allclose(tce.score_pairs(pairs), jce.score_pairs(pairs), **F32)


def test_load_params_npz_rejects_a_mismatch(tmp_path, monkeypatch):
    cfg = BertConfig(vocab_size=300, hidden_size=16, num_layers=1, num_heads=2,
                     intermediate_size=32)
    params = _numpy(jax_init_params(JaxBertConfig(vocab_size=300, hidden_size=16, num_layers=1,
                                                  num_heads=2, intermediate_size=32), seed=7))
    flat = {"params/" + "/".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    np.savez(tmp_path / "embedder_16x1.npz", **flat)
    monkeypatch.setattr(pretrained, "PRETRAINED_DIR", tmp_path)
    template = BertEncoder(cfg).state_dict()
    got = pretrained.shipped_embedder_params(cfg, template)
    for key, value in bert_params_from_jax(params).items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy())
    wide = BertEncoder(BertConfig(vocab_size=301, hidden_size=16, num_layers=1, num_heads=2,
                                  intermediate_size=32)).state_dict()
    assert pretrained.shipped_embedder_params(cfg, wide) is None  # vocab 301 != 300
    assert pretrained.shipped_cross_encoder_params(cfg, template) is None  # no such file
    np.savez(tmp_path / "embedder_16x1.npz", **{k: v for k, v in flat.items()
                                                 if "layer_0/mlp_in" not in k})
    assert pretrained.shipped_embedder_params(cfg, template) is None  # a leaf missing


def test_init_params_is_seeded():
    cfg = BertConfig(**SMALL)
    a, b, c = init_params(cfg, seed=3), init_params(cfg, seed=3), init_params(cfg, seed=4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_0.attention.query.weight"], c["layer_0.attention.query.weight"])
    assert torch.equal(a["emb_ln.weight"], torch.ones(32)) and not a["layer_0.mlp_in.bias"].any()
    std = float(a["word_emb.weight"].std())
    assert abs(std - 32 ** -0.5) < 0.02  # embeddings: variance 1 / features, as flax


def test_local_nlp_models_facade():
    jemb, temb = _embedders("float32")
    _, tce = _cross_encoders("float32")
    models = LocalNLPModels(embedder=temb, cross_encoder=tce)
    assert models.device == torch.device("cpu") and models.embedding_dimension == 32
    np.testing.assert_array_equal(models.embed(TEXTS[:3]), temb.embed(TEXTS[:3]))
    np.testing.assert_array_equal(models.embed_single(TEXTS[1]), temb.embed(TEXTS[1:2])[0])
    assert models.embed_device(TEXTS[:3], pad_to=4).shape == (4, 32)
    ranked = models.rerank("topic 1", TEXTS[:4], top_k=2)
    assert ranked == tce.rerank("topic 1", TEXTS[:4], top_k=2)
    lazy = LocalNLPModels(config_from_dict({"embedding": {"checkpoint_dir": ""}}), device="cpu")
    assert lazy._cross is None and lazy.cross_encoder.bert_cfg.hidden_size == 128
    assert lazy.embedder.bert_cfg.num_layers == 6  # the trainable-small preset


# -- local HF weights (a tiny random transformers model, as test_hf_parity.py) --

TINY_HF = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=512, type_vocab_size=2,
               hidden_act="gelu", layer_norm_eps=1e-12, attention_probs_dropout_prob=0.0,
               hidden_dropout_prob=0.0)
TINY = BertConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                  intermediate_size=64, dtype=torch.float32)


def _hf_inputs(seed):
    ids, mask, types = _inputs(seed, b=3, s=10, vocab=100)
    return ids, mask, types, {"input_ids": torch.from_numpy(ids.astype(np.int64)),
                              "attention_mask": torch.from_numpy(mask.astype(np.int64)),
                              "token_type_ids": torch.from_numpy(types.astype(np.int64))}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hf_bert_weights_load_like_jax(tmp_path, fmt):
    """The port's loader against HF's own forward and against the JAX
    package's loader + forward on the same checkpoint."""
    transformers = pytest.importorskip("transformers")
    from radiant_rag_tpu.models.hf_loading import try_load_bert_params as jax_load
    from radiant_rag_tpu_torch.models.hf_loading import try_load_bert_params

    torch.manual_seed(0)
    hf = transformers.BertModel(transformers.BertConfig(**TINY_HF)).eval()
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
                  str(tmp_path / "model.safetensors"))
    else:  # BertForSequenceClassification naming: bert.* prefixes
        cls = transformers.BertForSequenceClassification(
            transformers.BertConfig(num_labels=1, **TINY_HF)).eval()
        hf = cls.bert
        torch.save(cls.state_dict(), str(tmp_path / "pytorch_model.bin"))
    params = try_load_bert_params(str(tmp_path), TINY)
    model = BertEncoder(TINY)
    model.load_state_dict(params)
    ids, mask, types, hf_in = _hf_inputs(7)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
        ref = hf(**hf_in).last_hidden_state
    live = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[live], ref.numpy()[live], atol=2e-4, rtol=1e-3)
    jcfg = JaxBertConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, dtype=jnp.float32)
    jparams = jax_load(str(tmp_path), jcfg)
    jout = np.asarray(JaxBertEncoder(jcfg).apply(jparams, ids, mask, types))
    np.testing.assert_allclose(got.numpy()[live], jout[live], **F32)
    for key, value in bert_params_from_jax(_numpy(jparams)).items():
        np.testing.assert_array_equal(params[key].numpy(), value.numpy())


def test_hf_cross_encoder_weights_and_embedder_weights_path(tmp_path):
    transformers = pytest.importorskip("transformers")
    from safetensors.numpy import save_file as save_numpy

    from radiant_rag_tpu_torch.models.hf_loading import (
        try_load_bert_params, try_load_cross_encoder_params,
    )

    torch.manual_seed(2)
    hf = transformers.BertForSequenceClassification(
        transformers.BertConfig(num_labels=1, **TINY_HF)).eval()
    torch.save(hf.state_dict(), str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]"] + [f"[unused{i}]" for i in range(99)]) + "\n")
    ce = CrossEncoder(CrossEncoderConfig(weights_path=str(tmp_path), max_seq_len=16),
                      bert_cfg=TINY, device="cpu")
    ids, mask, types, hf_in = _hf_inputs(11)
    with torch.no_grad():
        ref = hf(**hf_in).logits[:, 0].numpy()
    got = ce.forward(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)
    assert type(ce.tokenizer).__name__ == "WordPieceTokenizer"
    emb = Embedder(EmbeddingConfig(preset="none", weights_path=str(tmp_path), dim=32,
                                   num_layers=2, num_heads=4, hidden_dim=64, vocab_size=100,
                                   dtype="float32", checkpoint_dir=""), device="cpu")
    sd = try_load_bert_params(str(tmp_path), TINY)
    assert all(torch.equal(emb.model.state_dict()[k], v) for k, v in sd.items())
    # a truncated state dict does not half-load
    bad = tmp_path / "bad"
    bad.mkdir()
    save_numpy({"embeddings.word_embeddings.weight": np.zeros((10, 8), np.float32)},
               str(bad / "model.safetensors"))
    assert try_load_bert_params(str(bad), TINY) is None
    assert try_load_cross_encoder_params(str(bad), TINY) is None
    assert try_load_bert_params(str(tmp_path / "missing"), TINY) is None
