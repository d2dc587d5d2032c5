"""Code-aware chunking: structure-preserving chunks for 20+ languages.

The port's copy of `radiant_rag_tpu/ingestion/code_chunker.py`, unchanged.
Capability parity with reference `ingestion/code_chunker.py`: language
detection by extension (`code_chunker.py:19-95`), Python parsed via `ast`
(classes/functions/methods with parent links, `:281-365`; regex fallback
`:366`), other languages via regex (`:390-560`), blocks rendered to
indexable text with import context + header metadata (`:118-150`), and
large-block splitting / small-block combining (`:668-774`).
"""

from __future__ import annotations

import ast
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

EXTENSION_LANGUAGES: Dict[str, str] = {
    ".py": "python", ".pyw": "python", ".pyx": "python",
    ".js": "javascript", ".jsx": "javascript", ".mjs": "javascript",
    ".ts": "typescript", ".tsx": "typescript",
    ".java": "java", ".kt": "kotlin", ".kts": "kotlin", ".scala": "scala",
    ".go": "go", ".rs": "rust",
    ".c": "c", ".h": "c",
    ".cpp": "cpp", ".cc": "cpp", ".cxx": "cpp", ".hpp": "cpp", ".hxx": "cpp",
    ".cs": "csharp",
    ".rb": "ruby", ".php": "php", ".swift": "swift",
    ".sh": "shell", ".bash": "shell", ".zsh": "shell",
    ".sql": "sql", ".r": "r", ".jl": "julia", ".lua": "lua",
    ".pl": "perl", ".m": "objc",
    # config/markup: no structural splitter — whole-file chunks keyed by
    # language so retrieval filters still see them as code-family docs
    ".yaml": "yaml", ".yml": "yaml", ".json": "json", ".toml": "toml",
}


def detect_language(path: str) -> Optional[str]:
    return EXTENSION_LANGUAGES.get(Path(path).suffix.lower())


@dataclass
class CodeChunk:
    content: str
    language: str
    kind: str  # module | class | function | method | block
    name: str = ""
    parent: str = ""
    source: str = ""
    start_line: int = 0
    end_line: int = 0
    imports: str = ""

    def to_indexable_text(self) -> str:
        """Header + import context + code (reference `code_chunker.py:118-150`)."""
        header = f"# {self.language} {self.kind}"
        if self.name:
            header += f": {self.parent + '.' if self.parent else ''}{self.name}"
        if self.source:
            header += f" ({self.source}:{self.start_line})"
        parts = [header]
        if self.imports and self.kind != "module":
            parts.append(f"# imports in scope:\n{self.imports}")
        parts.append(self.content)
        return "\n".join(parts)

    def meta(self) -> Dict[str, Any]:
        return {
            "language": self.language, "kind": self.kind, "name": self.name,
            "parent": self.parent, "start_line": self.start_line,
            "end_line": self.end_line,
        }


_REGEX_SPLITTERS: Dict[str, re.Pattern] = {
    "javascript": re.compile(r"(?m)^(?:export\s+)?(?:async\s+)?(?:function\s+\w+|class\s+\w+|const\s+\w+\s*=\s*(?:async\s*)?\()"),
    "typescript": re.compile(r"(?m)^(?:export\s+)?(?:async\s+)?(?:function\s+\w+|class\s+\w+|interface\s+\w+|const\s+\w+\s*=)"),
    "java": re.compile(r"(?m)^\s*(?:public|private|protected)\s+(?:static\s+)?(?:final\s+)?(?:class|interface|enum|\w+(?:<[^>]*>)?\s+\w+\s*\()"),
    "go": re.compile(r"(?m)^func\s+(?:\(\w+\s+\*?\w+\)\s+)?\w+|^type\s+\w+\s+(?:struct|interface)"),
    "rust": re.compile(r"(?m)^(?:pub\s+)?(?:fn|struct|enum|impl|trait|mod)\s+\w+"),
    "c": re.compile(r"(?m)^\w[\w\s\*]+\([^;]*\)\s*\{"),
    "cpp": re.compile(r"(?m)^(?:[\w:<>]+\s+)+[\w:]+\s*\([^;]*\)\s*\{|^(?:class|struct|namespace)\s+\w+"),
}

_NAME_RX = re.compile(r"(?:function|class|interface|fn|struct|enum|trait|mod|type|func)\s+(\w+)|(\w+)\s*[=(]")


class CodeChunker:
    def __init__(self, max_chunk_chars: int = 3000, min_chunk_chars: int = 80) -> None:
        self.max_chunk_chars = max_chunk_chars
        self.min_chunk_chars = min_chunk_chars

    # -- entry -------------------------------------------------------------
    def chunk_file(self, path: str) -> List[CodeChunk]:
        lang = detect_language(path)
        if lang is None:
            return []
        try:
            text = Path(path).read_text(errors="replace")
        except Exception as exc:
            logger.warning("cannot read %s: %s", path, exc)
            return []
        return self.chunk_text(text, lang, source=path)

    def chunk_text(self, text: str, language: str, source: str = "") -> List[CodeChunk]:
        if language == "python":
            chunks = self._chunk_python(text, source)
        else:
            chunks = self._chunk_regex(text, language, source)
        return self._postprocess(chunks)

    # -- python via ast ------------------------------------------------------
    def _chunk_python(self, text: str, source: str) -> List[CodeChunk]:
        try:
            tree = ast.parse(text)
        except SyntaxError:
            return self._chunk_regex(text, "python", source,
                                     rx=re.compile(r"(?m)^(?:def|class)\s+\w+"))
        lines = text.splitlines()
        imports = "\n".join(
            lines[n.lineno - 1] for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom)) and n.lineno <= len(lines)
        )
        chunks: List[CodeChunk] = []
        covered: set = set()

        def add(node, kind: str, parent: str = "") -> None:
            start, end = node.lineno, getattr(node, "end_lineno", node.lineno)
            covered.update(range(start, end + 1))
            chunks.append(CodeChunk(
                content="\n".join(lines[start - 1 : end]), language="python",
                kind=kind, name=node.name, parent=parent, source=source,
                start_line=start, end_line=end, imports=imports,
            ))

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(node, "function")
            elif isinstance(node, ast.ClassDef):
                # class shell (minus long methods) + each method separately
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        add(item, "method", parent=node.name)
                start, end = node.lineno, getattr(node, "end_lineno", node.lineno)
                chunks.append(CodeChunk(
                    content="\n".join(lines[start - 1 : min(end, start + 30)]),
                    language="python", kind="class", name=node.name,
                    source=source, start_line=start, end_line=end, imports=imports,
                ))
                covered.update(range(start, end + 1))

        # module-level remainder (constants, top-level code)
        remainder = [l for i, l in enumerate(lines, start=1)
                     if i not in covered and l.strip()]
        if remainder:
            chunks.insert(0, CodeChunk(
                content="\n".join(remainder), language="python", kind="module",
                name=Path(source).stem if source else "", source=source,
                start_line=1, end_line=len(lines), imports=imports,
            ))
        return chunks

    # -- regex languages -------------------------------------------------------
    def _chunk_regex(self, text: str, language: str, source: str,
                     rx: Optional[re.Pattern] = None) -> List[CodeChunk]:
        rx = rx or _REGEX_SPLITTERS.get(language)
        if rx is None:
            return [CodeChunk(content=text, language=language, kind="module",
                              source=source, start_line=1,
                              end_line=text.count("\n") + 1)]
        starts = [m.start() for m in rx.finditer(text)] or [0]
        if starts[0] != 0:
            starts.insert(0, 0)
        bounds = starts + [len(text)]
        chunks = []
        for i in range(len(bounds) - 1):
            piece = text[bounds[i] : bounds[i + 1]]
            if not piece.strip():
                continue
            name_m = _NAME_RX.search(piece)
            name = (name_m.group(1) or name_m.group(2)) if name_m else ""
            start_line = text[: bounds[i]].count("\n") + 1
            chunks.append(CodeChunk(
                content=piece.rstrip(), language=language,
                kind="block" if i else "module", name=name or "", source=source,
                start_line=start_line,
                end_line=start_line + piece.count("\n"),
            ))
        return chunks

    # -- sizing ------------------------------------------------------------
    def _postprocess(self, chunks: List[CodeChunk]) -> List[CodeChunk]:
        """Split oversized blocks; merge undersized neighbors
        (reference `code_chunker.py:668-774`)."""
        out: List[CodeChunk] = []
        for c in chunks:
            if len(c.content) <= self.max_chunk_chars:
                out.append(c)
                continue
            lines = c.content.splitlines()
            cur: List[str] = []
            part = 0
            for line in lines:
                cur.append(line)
                if sum(len(l) + 1 for l in cur) >= self.max_chunk_chars:
                    out.append(CodeChunk(
                        content="\n".join(cur), language=c.language, kind=c.kind,
                        name=f"{c.name}#part{part}" if c.name else "",
                        parent=c.parent, source=c.source,
                        start_line=c.start_line, end_line=c.end_line,
                        imports=c.imports))
                    cur, part = [], part + 1
            if cur:
                out.append(CodeChunk(
                    content="\n".join(cur), language=c.language, kind=c.kind,
                    name=f"{c.name}#part{part}" if c.name and part else c.name,
                    parent=c.parent, source=c.source, start_line=c.start_line,
                    end_line=c.end_line, imports=c.imports))
        # merge tiny NAMELESS neighbors (named defs keep their identity/metadata)
        merged: List[CodeChunk] = []
        for c in out:
            if (merged and not c.name and len(c.content) < self.min_chunk_chars
                    and merged[-1].language == c.language):
                merged[-1].content += "\n\n" + c.content
            else:
                merged.append(c)
        return merged
