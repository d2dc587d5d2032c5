"""Language detection + translation.

The port's copy of `radiant_rag_tpu/agents/language.py`: the offline
detector (`lang_profiles.classify`, a script gate and character n-gram
profiles, corroborated by stopwords on short texts), LLM detection when its
confidence is below `min_confidence`, and LLM translation split by
paragraph for long texts. The orchestrator's phase 0 runs them when
`language.enabled` is set. Plain Python and LLM calls: no device work.

One deviation: the JAX detector takes a `model_path` to a local fastText
model (and logs and goes on without it when the load fails). The
repository holds no such model and no config field sets one, so the port's
detector has no such parameter: the fastText detector is not ported.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Broad-coverage detector + 176-code name map live in lang_profiles
# (char-trigram profiles, script-gated; fills the breadth gap vs the
# reference's fastText lid.176).
from radiant_rag_tpu_torch.agents.lang_profiles import (  # noqa: E402
    LANGUAGE_NAMES,
    classify as _ngram_classify,
)

# High-signal stopword profiles for the top web languages: corroboration
# that boosts confidence on short texts where trigram statistics are thin.
_PROFILES: Dict[str, set] = {
    "en": {"the", "and", "of", "to", "is", "in", "that", "it", "for", "was", "with", "are"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "ein", "eine", "mit", "für", "auf", "ich"},
    "fr": {"le", "la", "les", "et", "est", "une", "des", "dans", "que", "pour", "pas", "je"},
    "es": {"el", "la", "los", "las", "es", "una", "del", "que", "por", "para", "con", "se"},
    "it": {"il", "la", "che", "di", "è", "un", "una", "per", "con", "non", "sono", "del"},
    "pt": {"o", "que", "de", "é", "um", "uma", "para", "com", "não", "os", "as", "do"},
    "nl": {"de", "het", "een", "en", "van", "is", "dat", "niet", "met", "voor", "zijn", "ik"},
    "ru": {"и", "в", "не", "на", "что", "это", "как", "он", "по", "но", "из", "его"},
}


class LanguageDetectionAgent:
    def __init__(self, llm=None, min_confidence: float = 0.5) -> None:
        self.llm = llm
        self.min_confidence = min_confidence

    def detect(self, text: str) -> Tuple[str, float]:
        """Returns (language_code, confidence)."""
        if not text.strip():
            return "en", 0.0
        code, conf = self._heuristic(text)
        if conf < self.min_confidence and self.llm is not None:
            llm_result = self._llm_detect(text)
            if llm_result is not None:
                return llm_result
        return code, conf

    def _heuristic(self, text: str) -> Tuple[str, float]:
        """Script gate + char-trigram profile classifier (~50 languages),
        with stopword corroboration for the top web languages."""
        sample = text[:2000]
        code, conf = _ngram_classify(sample)
        words = re.findall(r"[a-zà-ÿа-я]+", sample.lower())
        if words:
            scores = {c: sum(1 for w in words if w in prof) / len(words)
                      for c, prof in _PROFILES.items()}
            sw_code, sw_score = max(scores.items(), key=lambda kv: kv[1])
            if sw_score > 0.1:
                if sw_code == code:
                    conf = min(1.0, conf + sw_score)  # two independent signals
                elif sw_score > 0.25 and conf < 0.5:
                    # strong stopword signal overrides a weak trigram call
                    # (very short queries: function words beat trigram stats)
                    return sw_code, min(1.0, sw_score * 3)
        return code, conf

    def _llm_detect(self, text: str) -> Optional[Tuple[str, float]]:
        try:
            raw = self.llm.chat_json([{
                "role": "user",
                "content": ('Identify the language. Reply ONLY {"code": "ISO 639-1", '
                            f'"confidence": float 0-1}}.\n\nText: {text[:800]}'),
            }], expect=dict)
            if raw and raw.get("code"):
                return str(raw["code"]).lower()[:2], float(raw.get("confidence", 0.8) or 0.8)
        except Exception as exc:
            logger.warning("LLM language detection failed: %s", exc)
        return None


class TranslationAgent:
    def __init__(self, llm, canonical_language: str = "en",
                 max_chars_per_llm_call: int = 4000) -> None:
        self.llm = llm
        self.canonical_language = canonical_language
        self.max_chars = max_chars_per_llm_call

    def translate(self, text: str, target: Optional[str] = None,
                  source: Optional[str] = None) -> str:
        """Translate, splitting long texts by paragraph
        (reference `translation.py:252-374`)."""
        target = target or self.canonical_language
        if not text.strip():
            return text
        chunks = self._split(text)
        out = []
        target_name = LANGUAGE_NAMES.get(target, target)
        for chunk in chunks:
            src_note = f" from {LANGUAGE_NAMES.get(source, source)}" if source else ""
            translated = self.llm.chat([{
                "role": "user",
                "content": (f"Translate the following text{src_note} to {target_name}. "
                            "Output ONLY the translation, preserving formatting.\n\n" + chunk),
            }])
            out.append(translated.strip())
        return "\n\n".join(out)

    def translate_with_detection(self, text: str, detector: LanguageDetectionAgent) -> Dict[str, Any]:
        code, conf = detector.detect(text)
        if code == self.canonical_language:
            return {"text": text, "translated": False, "source_language": code,
                    "confidence": conf}
        return {"text": self.translate(text, source=code), "translated": True,
                "source_language": code, "confidence": conf}

    def translate_batch(self, texts: List[str], target: Optional[str] = None) -> List[str]:
        return [self.translate(t, target=target) for t in texts]

    def _split(self, text: str) -> List[str]:
        if len(text) <= self.max_chars:
            return [text]
        paragraphs = text.split("\n\n")
        chunks: List[str] = []
        cur = ""
        for p in paragraphs:
            if len(cur) + len(p) + 2 > self.max_chars and cur:
                chunks.append(cur)
                cur = p
            else:
                cur = f"{cur}\n\n{p}" if cur else p
            while len(cur) > self.max_chars:  # single huge paragraph
                chunks.append(cur[: self.max_chars])
                cur = cur[self.max_chars :]
        if cur:
            chunks.append(cur)
        return chunks
