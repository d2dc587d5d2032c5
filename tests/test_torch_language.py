"""The port's language phase against the JAX package's (CPU).

The offline detector (`agents/lang_profiles.py`) classifies every held-out
sentence of tests/test_lang_profiles.py exactly as the JAX package does,
code and confidence; the detection and translation agents match on the
cases of tests/test_agents2.py; and the orchestrator's phase 0 gives the
same `result.language`, the same translated query and the same fused and
reranked docs as the JAX orchestrator (tests/_torch_agentic_world.py's
tolerance), equal to a direct run of the English question, makes no
translation call for an English query, and degrades a failed translation
as the JAX package does.
"""

import pytest

from radiant_rag_tpu.agents import lang_profiles as jlp
from radiant_rag_tpu.agents.language import LanguageDetectionAgent as JaxDetector
from radiant_rag_tpu.agents.language import TranslationAgent as JaxTranslator
from radiant_rag_tpu.llm.backends import MockLLMBackend as JaxMock
from radiant_rag_tpu.llm.client import LLMClient as JaxClient
from radiant_rag_tpu_torch.agents import lang_profiles as tlp
from radiant_rag_tpu_torch.agents.language import LanguageDetectionAgent, TranslationAgent
from radiant_rag_tpu_torch.config import LLMConfig
from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
from radiant_rag_tpu_torch.llm.client import LLMClient

from _torch_agentic_world import assert_runs_match, make_stacks, orchestrators, replace_sections
from test_lang_profiles import HELD_OUT

GERMAN = "Wie erzeugen die Mitochondrien die Energie für die Zelle und was ist ATP?"
FRENCH = "Comment les mitochondries produisent-elles l'énergie de la cellule?"
ENGLISH = "How do mitochondria produce the energy of the cell and what is ATP?"
TRANSLATIONS = {GERMAN: ENGLISH, FRENCH: ENGLISH}


def clients(responder, max_retries=2):
    """(JAX client, port client) over each package's mock of `responder`."""
    from radiant_rag_tpu import config as jcfg

    return (JaxClient(jcfg.LLMConfig(max_retries=max_retries),
                      backend=JaxMock(responder=responder)),
            LLMClient(LLMConfig(max_retries=max_retries),
                      backend=MockLLMBackend(responder=responder)))


@pytest.mark.parametrize("accept, text", HELD_OUT, ids=[sorted(a)[0] for a, _ in HELD_OUT])
def test_held_out_classification_matches_jax(accept, text):
    got, ref = tlp.classify(text), jlp.classify(text)
    assert got == ref and got[0] in accept


def test_profiles_breadth_and_names_match_jax():
    assert tlp.LANGUAGE_NAMES == jlp.LANGUAGE_NAMES
    assert tlp.NgramLanguageClassifier().languages == jlp.NgramLanguageClassifier().languages
    for text in ("12345 67890 ---", "", "The committee will meet on Thursday to discuss the "
                 "new budget proposal.", "was ist das für ein"):
        assert tlp.classify(text) == jlp.classify(text), text


@pytest.mark.parametrize("text", [
    "the quick brown fox is one of the animals",
    "der hund ist nicht auf der straße und das ist gut",
    "это русский текст и он написан на русском языке",
    "日本語のテキストです。これはテストです。",
    "Das ist ein ganz normaler deutscher Satz über das Wetter.",
    "Ceci est une phrase française tout à fait ordinaire.",
    "was ist das für ein",
    GERMAN, FRENCH, ENGLISH,
])
def test_detector_matches_jax(text):
    assert LanguageDetectionAgent().detect(text) == JaxDetector().detect(text)


def test_low_confidence_asks_the_llm_as_jax_does():
    calls = {"j": 0, "t": 0}

    def responder(key):
        def reply(messages):
            calls[key] += 1
            return '{"code": "PT-br", "confidence": 0.7}'
        return reply

    text = "ok ok"  # no trigram or stopword signal: below min_confidence
    jllm, _ = clients(responder("j"))
    _, tllm = clients(responder("t"))
    ref = JaxDetector(llm=jllm, min_confidence=0.5).detect(text)
    got = LanguageDetectionAgent(llm=tllm, min_confidence=0.5).detect(text)
    assert got == ref == ("pt", 0.7) and calls == {"j": 1, "t": 1}


def test_fasttext_model_path_is_refused():
    """The fastText detector is not ported: the port's detector has no
    `model_path` parameter (the JAX one takes it)."""
    JaxDetector(model_path="")
    with pytest.raises(TypeError, match="model_path"):
        LanguageDetectionAgent(model_path="/models/lid.176.bin")


def test_translation_splits_long_text_as_jax():
    seen = {"j": [], "t": []}

    def responder(key):
        def reply(messages):
            seen[key].append(messages[-1]["content"])
            return f"TRANSLATED {len(seen[key])}"
        return reply

    text = "\n\n".join(["para " + "x" * 40] * 5)
    jllm, _ = clients(responder("j"))
    _, tllm = clients(responder("t"))
    ref = JaxTranslator(jllm, max_chars_per_llm_call=100).translate(text, target="de",
                                                                      source="fr")
    got = TranslationAgent(tllm, max_chars_per_llm_call=100).translate(text, target="de",
                                                                        source="fr")
    assert got == ref and seen["t"] == seen["j"] and len(seen["t"]) >= 2
    assert "from French to German" in seen["t"][0]
    for long in ("y" * 250, ""):  # one huge paragraph; an empty text makes no call
        assert TranslationAgent(tllm, max_chars_per_llm_call=100)._split(long) == \
            JaxTranslator(jllm, max_chars_per_llm_call=100)._split(long)


def test_translate_with_detection_matches_jax():
    def responder(messages):
        return TRANSLATIONS.get(messages[-1]["content"].rsplit("\n\n", 1)[-1],
                                "SHOULD NOT BE CALLED")

    jllm, tllm = clients(responder)
    for text in (GERMAN, FRENCH, "the quick brown fox is an animal of the forest"):
        ref = JaxTranslator(jllm).translate_with_detection(text, JaxDetector())
        got = TranslationAgent(tllm).translate_with_detection(text, LanguageDetectionAgent())
        assert got == ref
        assert got["translated"] == (text != "the quick brown fox is an animal of the forest")


# ---------------------------------------------------------------- phase 0
@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    return make_stacks(tmp_path_factory.mktemp("lang"))


SCRIPT = {f"\n\n{src}": dst for src, dst in TRANSLATIONS.items()}
ON = {"language": {"enabled": True}}


@pytest.mark.parametrize("question,code", [(GERMAN, "de"), (FRENCH, "fr")])
def test_phase0_translates_and_retrieves_as_jax(stacks, question, code):
    jo, to = orchestrators(stacks, script=SCRIPT, sections=ON)
    ref, got = jo.run(question), to.run(question)
    assert_runs_match(ref, got)
    assert got.language == ref.language
    assert got.language["source_language"] == code and got.language["translated"]
    assert [s["name"] for s in got.metrics["steps"]][0] == "language"
    # the same docs as a direct run of the English question, language off
    _, direct = orchestrators(stacks, script=SCRIPT)
    plain = direct.run(ENGLISH)
    assert [d.doc_id for d, _ in got.fused_docs] == [d.doc_id for d, _ in plain.fused_docs]
    assert [d.doc_id for d, _ in got.reranked_docs] == \
        [d.doc_id for d, _ in plain.reranked_docs]
    assert got.answer == plain.answer and not got.degraded


def test_phase0_english_makes_no_translation_call(stacks):
    jo, to = orchestrators(stacks, script=SCRIPT, sections=ON)
    ref, got = jo.run(ENGLISH), to.run(ENGLISH)
    assert_runs_match(ref, got)
    assert got.language == ref.language and got.language["translated"] is False
    assert not any(key.startswith("\n\n") for key in to.llm.backend.responder.counts)
    assert got.query == ENGLISH


def test_phase0_llm_failure_degrades_as_jax(stacks):
    """A translation the LLM cannot give marks the run degraded with
    "language" and runs on with the question as asked, in both packages."""
    from radiant_rag_tpu.orchestrator import RAGOrchestrator as JaxOrchestrator
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    from _torch_agentic_world import Responder

    class Down(Responder):
        def __call__(self, messages):
            if messages[-1]["content"].startswith("Translate the following text"):
                raise RuntimeError("translation backend down")
            return super().__call__(messages)

    runs = []
    for key, make, llm in (("j", JaxOrchestrator, clients(Down(), 0)[0]),
                           ("t", RAGOrchestrator, clients(Down(), 0)[1])):
        cfg, store, bm25, models = stacks[key]
        cfg = replace_sections(cfg, language={"enabled": True},
                               strategy_memory={"path": f"{cfg.strategy_memory.path}.down"})
        runs.append(make(cfg, store, bm25, models, llm).run(GERMAN))
    ref, got = runs
    assert_runs_match(ref, got)
    assert "language" in got.degraded and got.language == ref.language == {}
    assert got.success
