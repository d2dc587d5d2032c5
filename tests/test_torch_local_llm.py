"""The in-process generation backend (`llm/local_backend.py`) against the
JAX package's, on the CPU: a real transformers causal LM (a tiny
random-weight GPT-2 with a word-level tokenizer built here, no network, as
tests/test_local_llm.py builds it) goes through both backends; generated
text, streamed text and the prompt equal exactly (float32, device "cpu").
The port's `llm.device` defaults to the card: without one its load is a
permanent LLMError, never a move to the CPU."""

import sys

import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from radiant_rag_tpu.config import LLMConfig as JaxLLMConfig
from radiant_rag_tpu.llm import local_backend as jlocal
from radiant_rag_tpu_torch.config import LLMConfig, config_from_dict
from radiant_rag_tpu_torch.llm import local_backend as tlocal
from radiant_rag_tpu_torch.llm.backends import LLMError, create_llm_backend
from radiant_rag_tpu_torch.llm.client import LLMClient

WORDS = ["<unk>", "<eos>", "User", "Assistant", "System", ":", "hello", "world", "what", "is",
         "a", "tpu", "the", "answer", "good"]
PROMPTS = [[{"role": "user", "content": "what is a tpu"}],
           [{"role": "system", "content": "be good"}, {"role": "user", "content": "hello world"}],
           [{"role": "user", "content": "the answer is"}]]


def _tiny_model_and_tokenizer(tmp_path):
    """Tiny GPT-2 (2 layers, 32 wide) + a word-level tokenizer saved to disk
    and reloaded through AutoTokenizer."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import AutoTokenizer, GPT2Config, GPT2LMHeadModel, PreTrainedTokenizerFast

    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="<eos>",
                                   pad_token="<eos>")
    fast.save_pretrained(str(tmp_path / "tok"))
    tokenizer = AutoTokenizer.from_pretrained(str(tmp_path / "tok"))
    cfg = GPT2Config(vocab_size=len(WORDS), n_positions=64, n_embd=32, n_layer=2, n_head=2,
                     bos_token_id=1, eos_token_id=1)
    torch.manual_seed(0)
    return GPT2LMHeadModel(cfg).eval(), tokenizer


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llm")
    model, tokenizer = _tiny_model_and_tokenizer(tmp)
    jb = jlocal.LocalTransformersLLMBackend(
        JaxLLMConfig(backend="local", model_path=str(tmp), device="cpu", temperature=0.0),
        model=model, tokenizer=tokenizer)
    tb = tlocal.LocalTransformersLLMBackend(
        LLMConfig(backend="local", model_path=str(tmp), device="cpu", temperature=0.0),
        model=model, tokenizer=tokenizer)
    return jb, tb


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_greedy_chat_equals_jax(backends, i):
    jb, tb = backends
    got = tb.chat(PROMPTS[i], temperature=0.0, max_tokens=8)
    assert got == jb.chat(PROMPTS[i], temperature=0.0, max_tokens=8)
    assert got.strip() and set(got.split()) <= set(WORDS[2:])
    assert tb.chat(PROMPTS[i], temperature=0.0, max_tokens=8) == got  # deterministic


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_stream_equals_chat_and_jax(backends, i):
    jb, tb = backends
    chunks = list(tb.chat_stream(PROMPTS[i], temperature=0.0, max_tokens=8))
    assert chunks == list(jb.chat_stream(PROMPTS[i], temperature=0.0, max_tokens=8))
    assert len(chunks) >= 1
    assert "".join(chunks).split() == tb.chat(PROMPTS[i], temperature=0.0, max_tokens=8).split()


def test_sampling_under_one_seed_equals_jax(backends):
    jb, tb = backends
    torch.manual_seed(7)
    ref = jb.chat(PROMPTS[0], temperature=0.9, max_tokens=8)
    torch.manual_seed(7)
    assert tb.chat(PROMPTS[0], temperature=0.9, max_tokens=8) == ref


def test_prompt_formatting_equals_jax():
    msgs = [{"role": "system", "content": "be terse"}, {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"}, {"role": "user", "content": "again"}]
    prompt = tlocal._format_messages(msgs)
    assert prompt == jlocal._format_messages(msgs)
    assert prompt.startswith("System: be terse") and prompt.endswith("Assistant:")


def test_factory_builds_it_and_the_load_is_lazy_and_permanent(tmp_path):
    """llm.backend 'local' builds the backend (no raise); nothing loads
    until the first chat, whose failure on missing files is permanent."""
    cfg = config_from_dict({"llm": {"backend": "local", "model_path": str(tmp_path / "nope"),
                                    "device": "cpu"}}).llm
    b = create_llm_backend(cfg)
    assert isinstance(b, tlocal.LocalTransformersLLMBackend) and b._model is None
    with pytest.raises(LLMError) as ei:
        b.chat([{"role": "user", "content": "hi"}])
    assert ei.value.status == 400 and not ei.value.retryable
    client = LLMClient(cfg)
    assert isinstance(client.backend, tlocal.LocalTransformersLLMBackend)


def test_full_model_load_from_disk_equals_jax(tmp_path):
    """Through AutoModelForCausalLM.from_pretrained on saved weights, the
    path a mounted-weights deployment takes, in float32 on the CPU."""
    model, tokenizer = _tiny_model_and_tokenizer(tmp_path)
    model.save_pretrained(str(tmp_path / "model"))
    tokenizer.save_pretrained(str(tmp_path / "model"))
    path = str(tmp_path / "model")
    tb = tlocal.LocalTransformersLLMBackend(LLMConfig(backend="local", model_path=path,
                                                      device="cpu"))
    jb = jlocal.LocalTransformersLLMBackend(JaxLLMConfig(backend="local", model_path=path,
                                                         device="cpu"))
    out = tb.chat([{"role": "user", "content": "hello"}], temperature=0.0, max_tokens=6)
    assert out.strip() and out == jb.chat([{"role": "user", "content": "hello"}],
                                          temperature=0.0, max_tokens=6)
    assert tb._model.dtype == torch.float32 and tb._model.device.type == "cpu"


def test_device_defaults_to_the_card_and_a_missing_card_is_an_error(tmp_path):
    """llm.device is "cuda" unless the configuration asks for the CPU
    (the JAX package's default is "cpu"); without a card the load raises a
    permanent LLMError naming CUDA and does not move to the CPU."""
    assert LLMConfig().device == "cuda" and JaxLLMConfig().device == "cpu"
    model, tokenizer = _tiny_model_and_tokenizer(tmp_path)
    model.save_pretrained(str(tmp_path / "m"))
    tokenizer.save_pretrained(str(tmp_path / "m"))
    b = tlocal.LocalTransformersLLMBackend(LLMConfig(backend="local",
                                                     model_path=str(tmp_path / "m")))
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default loads onto it")
    with pytest.raises(LLMError, match="CUDA") as ei:
        b.chat([{"role": "user", "content": "hi"}])
    assert ei.value.status == 400 and b._model is None


def test_missing_transformers_is_a_permanent_error_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    b = tlocal.LocalTransformersLLMBackend(LLMConfig(backend="local", device="cpu",
                                                     model_path=str(tmp_path)))
    with pytest.raises(LLMError, match="transformers") as ei:
        b.chat([{"role": "user", "content": "hi"}])
    assert ei.value.status == 400
