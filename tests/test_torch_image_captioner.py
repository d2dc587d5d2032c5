"""The image captioner (`ingestion/image_captioner.py`) against the JAX
package's on the CPU, as tests/test_image_captioner.py holds the JAX one:
a real transformers VisionEncoderDecoder (tiny random ViT -> GPT-2, built
here, no network) through both packages' `create_captioner`; captions
equal exactly (float32, device "cpu"). The metadata captioner and the
fallback without a checkpoint equal the JAX package's too."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
PIL = pytest.importorskip("PIL")

from radiant_rag_tpu.ingestion import image_captioner as jcap
from radiant_rag_tpu_torch.ingestion import image_captioner as tcap


@pytest.fixture(scope="module")
def vlm_dir(tmp_path_factory):
    """A tiny VisionEncoderDecoder checkpoint saved to disk."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import (GPT2Config, PreTrainedTokenizerFast, ViTConfig, ViTImageProcessor,
                              VisionEncoderDecoderConfig, VisionEncoderDecoderModel)

    d = tmp_path_factory.mktemp("vlm")
    vit = ViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, image_size=32, patch_size=16)
    gpt = GPT2Config(vocab_size=50, n_embd=32, n_layer=1, n_head=2, n_positions=32,
                     add_cross_attention=True, is_decoder=True, bos_token_id=0, eos_token_id=1,
                     pad_token_id=1)
    cfg = VisionEncoderDecoderConfig.from_encoder_decoder_configs(vit, gpt)
    cfg.decoder_start_token_id = 0
    cfg.pad_token_id = 1
    torch.manual_seed(0)
    VisionEncoderDecoderModel(cfg).eval().save_pretrained(str(d))
    ViTImageProcessor(size={"height": 32, "width": 32}).save_pretrained(str(d))
    tok = Tokenizer(WordLevel({f"tok{i}": i for i in range(50)}, unk_token="tok0"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="tok0", eos_token="tok1",
                            pad_token="tok1").save_pretrained(str(d))
    return str(d)


def _image(tmp_path, name, seed, size=(32, 32)):
    from PIL import Image

    arr = (np.random.default_rng(seed).random((size[1], size[0], 3)) * 255).astype("uint8")
    p = tmp_path / name
    Image.fromarray(arr).save(p)
    return str(p)


@pytest.mark.parametrize("seed,size", [(0, (32, 32)), (1, (48, 20)), (2, (64, 64))])
def test_vlm_captioner_equals_jax(vlm_dir, tmp_path, seed, size):
    path = _image(tmp_path, f"img_{seed}.png", seed, size)
    got = tcap.create_captioner(vlm_dir, device="cpu")
    ref = jcap.create_captioner(vlm_dir)
    assert isinstance(got, tcap.HuggingFaceVLMCaptioner)
    assert got.caption(path) == ref.caption(path)
    assert all(w.startswith("tok") for w in got.caption(path).split())
    assert next(got.model.parameters()).device.type == "cpu"


def test_metadata_captioner_and_the_fallback_equal_jax(tmp_path):
    path = _image(tmp_path, "sunset_over-lake.png", 3)
    got = tcap.create_captioner(str(tmp_path / "missing"))
    assert isinstance(got, tcap.MetadataCaptioner)
    assert got.caption(path) == jcap.create_captioner("").caption(path)
    assert "sunset over lake" in got.caption(path) and "32x32 PNG" in got.caption(path)
    junk = tmp_path / "not_an_image.png"
    junk.write_text("junk")
    assert tcap.MetadataCaptioner().caption(str(junk)) == \
        jcap.MetadataCaptioner().caption(str(junk)) == "Image: not an image"
    assert tcap.IMAGE_EXTENSIONS == jcap.IMAGE_EXTENSIONS


def test_vlm_defaults_to_the_card(vlm_dir):
    """device None is the card: without one the captioner raises, and so
    does create_captioner over a checkpoint (no move to the CPU, no
    metadata caption in its place)."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcap.HuggingFaceVLMCaptioner(vlm_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcap.create_captioner(vlm_dir)


def test_missing_transformers_names_the_package(vlm_dir, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tcap.HuggingFaceVLMCaptioner(vlm_dir, device="cpu")
    # create_captioner turns to the metadata captioner, as the JAX one does
    assert isinstance(tcap.create_captioner(vlm_dir, device="cpu"), tcap.MetadataCaptioner)
