"""Document processing: file parsing -> cleaning -> chunks.

The port's copy of `IngestedChunk`, `html_to_text`, `ChunkSplitter` and
`DocumentProcessor` from `radiant_rag_tpu/ingestion/processor.py`, with
their behaviour unchanged: plain text, markdown, html, csv, json / jsonl
(`ingestion/json_parser.py`) and code (`ingestion/code_chunker.py`) are
read without optional libraries; pdf takes pypdf (or PyPDF2) when
importable and `unstructured` where the strategy asks for it, and without
them logs and skips the file as the JAX package does.
`IntelligentDocumentProcessor` (sections through the chunking agent,
`agents/chunking.py`) and `TranslatingDocumentProcessor` (each chunk's
language detected and translated to the canonical language, the original
kept in its meta) are library classes, as in the JAX package: no app path
builds them, and `ingestion.use_intelligent_chunking` /
`translate_at_ingestion` are read by neither package.
"""

from __future__ import annotations

import html.parser
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Sequence

logger = logging.getLogger(__name__)

TEXT_EXTENSIONS = {".txt", ".md", ".rst", ".text", ".log"}
HTML_EXTENSIONS = {".html", ".htm", ".xhtml"}
CODE_EXTENSIONS = {".py", ".js", ".ts", ".java", ".go", ".rs", ".c", ".cpp", ".h",
                   ".hpp", ".rb", ".php", ".swift", ".kt", ".scala", ".sh", ".sql",
                   ".cs", ".m", ".r", ".jl", ".lua", ".pl"}


@dataclass
class IngestedChunk:
    content: str
    meta: Dict[str, Any] = field(default_factory=dict)


class _HTMLTextExtractor(html.parser.HTMLParser):
    _SKIP = {"script", "style", "noscript", "head", "meta", "link"}

    def __init__(self) -> None:
        super().__init__()
        self.parts: List[str] = []
        self.title = ""
        self._skip_depth = 0
        self._in_title = False

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP:
            self._skip_depth += 1
        if tag == "title":
            self._in_title = True
        if tag in ("p", "div", "br", "li", "h1", "h2", "h3", "h4", "tr"):
            self.parts.append("\n")

    def handle_endtag(self, tag):
        if tag in self._SKIP and self._skip_depth:
            self._skip_depth -= 1
        if tag == "title":
            self._in_title = False

    def handle_data(self, data):
        if self._in_title:
            self.title += data
        elif not self._skip_depth:
            self.parts.append(data)

    def text(self) -> str:
        raw = "".join(self.parts)
        return re.sub(r"\n{3,}", "\n\n", re.sub(r"[ \t]+", " ", raw)).strip()


def html_to_text(content: str) -> tuple:
    """Returns (text, title)."""
    parser = _HTMLTextExtractor()
    try:
        parser.feed(content)
    except Exception:
        pass
    return parser.text(), parser.title.strip()


class ChunkSplitter:
    """Fixed-size char splitter with overlap (reference `processor.py:369-460`),
    preferring to break at whitespace near the boundary."""

    def __init__(self, chunk_size: int = 512, overlap: int = 50) -> None:
        if overlap >= chunk_size:
            raise ValueError("overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.overlap = overlap

    def split(self, text: str) -> List[str]:
        text = text.strip()
        if not text:
            return []
        if len(text) <= self.chunk_size:
            return [text]
        chunks: List[str] = []
        start = 0
        while start < len(text):
            end = min(start + self.chunk_size, len(text))
            if end < len(text):
                # break at the last whitespace in the final 20% of the window
                window = text[start:end]
                ws = window.rfind(" ", int(self.chunk_size * 0.8))
                if ws > 0:
                    end = start + ws
            chunks.append(text[start:end].strip())
            if end >= len(text):
                break
            start = max(end - self.overlap, start + 1)
        return [c for c in chunks if c]


class DocumentProcessor:
    """Parse files into cleaned chunks."""

    def __init__(self, chunk_size: int = 2000, overlap: int = 100,
                 clean_whitespace: bool = True, min_chunk_chars: int = 20,
                 pdf_strategy: str = "auto") -> None:
        self.splitter = ChunkSplitter(chunk_size, overlap)
        self.clean_whitespace = clean_whitespace
        self.min_chunk_chars = min_chunk_chars
        self.pdf_strategy = pdf_strategy  # auto | fast | hi_res | ocr_only

    # -- parsing -----------------------------------------------------------
    def parse_file(self, path: Path) -> List[tuple]:
        """Returns [(text, extra_meta)] sections for a file."""
        ext = path.suffix.lower()
        if ext in HTML_EXTENSIONS:
            text, title = html_to_text(path.read_text(errors="replace"))
            return [(text, {"title": title})] if text else []
        if ext == ".json" or ext == ".jsonl":
            from radiant_rag_tpu_torch.ingestion.json_parser import StructuredJSONParser

            return [(t, m) for t, m in StructuredJSONParser().parse_file(str(path))]
        if ext == ".pdf":
            return self._parse_pdf(path)
        if ext in CODE_EXTENSIONS:
            from radiant_rag_tpu_torch.ingestion.code_chunker import CodeChunker

            chunker = CodeChunker()
            return [(c.to_indexable_text(), c.meta()) for c in chunker.chunk_file(str(path))]
        if ext == ".csv":
            return self._parse_csv(path)
        # default: treat as text
        try:
            return [(path.read_text(errors="replace"), {})]
        except Exception as exc:
            logger.warning("cannot read %s: %s", path, exc)
            return []

    def _parse_pdf(self, path: Path) -> List[tuple]:
        """PDF partition per self.pdf_strategy (reference strategy surface,
        `ingestion/processor.py:236-273`): 'fast' reads the text layer only;
        'hi_res'/'ocr_only' force the corresponding `unstructured` strategy;
        'auto' reads the text layer and falls back to unstructured/OCR when
        a page has no extractable text (scanned documents)."""
        strategy = self.pdf_strategy
        if strategy in ("hi_res", "ocr_only"):
            out = self._parse_pdf_unstructured(path, strategy)
            if out is not None:
                return out
            logger.warning(
                "pdf_strategy=%s needs `unstructured`, which is unavailable; "
                "degrading to text-layer extraction for %s", strategy, path)
        out, empty_pages = self._parse_pdf_textlayer(path)
        if strategy == "auto" and empty_pages and not out:
            ocr = self._parse_pdf_unstructured(path, "auto")
            if ocr:
                return ocr
        return out

    def _parse_pdf_textlayer(self, path: Path):
        try:
            from pypdf import PdfReader  # optional
        except ImportError:
            try:
                from PyPDF2 import PdfReader  # type: ignore
            except ImportError:
                logger.warning("no PDF library available; skipping %s", path)
                return [], 0
        try:
            reader = PdfReader(str(path))
            out, empty = [], 0
            for i, page in enumerate(reader.pages):
                text = page.extract_text() or ""
                if text.strip():
                    out.append((text, {"page": i + 1}))
                else:
                    empty += 1
            return out, empty
        except Exception as exc:
            logger.warning("pdf parse failed for %s: %s", path, exc)
            return [], 0

    @staticmethod
    def _parse_pdf_unstructured(path: Path, strategy: str):
        """unstructured partition with an explicit strategy; None when the
        dependency (or its OCR stack) is unavailable."""
        try:
            from unstructured.partition.pdf import partition_pdf  # optional
        except ImportError:
            return None
        try:
            elements = partition_pdf(filename=str(path), strategy=strategy)
        except Exception as exc:
            logger.warning("unstructured(%s) failed for %s: %s",
                           strategy, path, exc)
            return None
        out = []
        for el in elements:
            text = str(el).strip()
            if text:
                meta = {"partition_strategy": strategy}
                page = getattr(getattr(el, "metadata", None), "page_number", None)
                if page is not None:
                    meta["page"] = page
                out.append((text, meta))
        return out

    def _parse_csv(self, path: Path) -> List[tuple]:
        import csv

        out = []
        try:
            with open(path, newline="", errors="replace") as fh:
                reader = csv.DictReader(fh)
                rows = list(reader)
            for i in range(0, len(rows), 50):
                block = rows[i : i + 50]
                text = "\n".join(
                    "; ".join(f"{k}: {v}" for k, v in row.items() if v) for row in block
                )
                out.append((text, {"rows": f"{i+1}-{i+len(block)}"}))
        except Exception as exc:
            logger.warning("csv parse failed for %s: %s", path, exc)
        return out

    # -- cleaning ----------------------------------------------------------
    def clean(self, text: str) -> str:
        if self.clean_whitespace:
            text = re.sub(r"[ \t]+", " ", text)
            text = re.sub(r"\n{3,}", "\n\n", text)
        return text.strip()

    # -- entry points ------------------------------------------------------
    def process_file(self, path: str) -> List[IngestedChunk]:
        p = Path(path)
        if not p.is_file():
            logger.warning("not a file: %s", path)
            return []
        chunks: List[IngestedChunk] = []
        for text, extra in self.parse_file(p):
            text = self.clean(text)
            for j, piece in enumerate(self._split_section(text, extra)):
                if len(piece) < self.min_chunk_chars:
                    continue
                meta = {"source": str(p), "chunk_index": len(chunks), **extra}
                chunks.append(IngestedChunk(content=piece, meta=meta))
        return chunks

    def _split_section(self, text: str, extra: Dict[str, Any]) -> List[str]:
        return self.splitter.split(text)

    def process_paths(self, paths: Sequence[str], recursive: bool = True) -> List[IngestedChunk]:
        out: List[IngestedChunk] = []
        for raw in paths:
            p = Path(raw)
            if p.is_dir():
                pattern = "**/*" if recursive else "*"
                for f in sorted(p.glob(pattern)):
                    if f.is_file() and not f.name.startswith("."):
                        out.extend(self.process_file(str(f)))
            elif p.is_file():
                out.extend(self.process_file(str(p)))
            else:
                logger.warning("path not found: %s", raw)
        return out


class IntelligentDocumentProcessor(DocumentProcessor):
    """Routes prose/markdown through the IntelligentChunkingAgent
    (reference `processor.py:635-797`)."""

    def __init__(self, chunking_agent, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.chunking_agent = chunking_agent

    def _split_section(self, text: str, extra: Dict[str, Any]) -> List[str]:
        try:
            chunks = self.chunking_agent.chunk(text)
            if chunks:
                return [c.content for c in chunks]
        except Exception as exc:
            logger.warning("intelligent chunking failed, falling back: %s", exc)
        return super()._split_section(text, extra)


class TranslatingDocumentProcessor(DocumentProcessor):
    """Detect language per chunk and translate to the canonical language at
    ingestion, preserving the original in meta (reference `processor.py:799-1077`)."""

    def __init__(self, detector, translator, canonical_language: str = "en",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.detector = detector
        self.translator = translator
        self.canonical_language = canonical_language

    def process_file(self, path: str) -> List[IngestedChunk]:
        chunks = super().process_file(path)
        out = []
        for chunk in chunks:
            try:
                code, conf = self.detector.detect(chunk.content)
            except Exception:
                code, conf = self.canonical_language, 0.0
            meta = dict(chunk.meta)
            meta["language_code"] = code
            content = chunk.content
            if code != self.canonical_language and conf >= 0.5:
                try:
                    translated = self.translator.translate(content, source=code)
                    meta["original_content"] = content
                    meta["original_language"] = code
                    meta["language_code"] = self.canonical_language
                    content = translated
                except Exception as exc:
                    logger.warning("translation failed: %s", exc)
            out.append(IngestedChunk(content=content, meta=meta))
        return out
