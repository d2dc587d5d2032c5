"""Configuration: every section of the JAX package's `AppConfig`.

The port's own copy of the 33 section dataclasses of
`radiant_rag_tpu/config.py`, with the same fields, defaults, coercion of
YAML values (lists to tuples included) and validation, so a YAML file gives
the two packages equal sections. No section is dropped: a section name the
loader does not know is logged, as the JAX loader logs an unknown key.

Values resolve as in the JAX package: environment > file > defaults. An
environment variable `RADIANT_<SECTION>_<FIELD>` (upper case, e.g.
`RADIANT_INDEX_DATA_DIR`) overrides that field of the file's section, and
counts as set by the user for the embedding preset below. A machine
without PyYAML configures the port through these and `config_from_dict`.

Two deviations from the JAX package's `load_config`:
  * it raises when the file is missing, PyYAML is missing or the file does
    not parse; the JAX package warns and serves the defaults, which would
    silently run another configuration;
  * for the same reason a field the port parses but has no behaviour for
    (`_NOT_PORTED`) raises `NotImplementedError` on any value but its
    default, naming the ROADMAP item that brings it, or saying that neither
    package reads it.

The embedding preset is resolved as the JAX package's `load_config` does
(`_apply_embedding_preset`): "auto" means "trainable-small" for a weightless
jax embedder; "trainable-small" sets the embedding and (without a
cross-encoder weights_path) the cross-encoder fields the file does not set
to the shape of the shipped 128 x 6 artifacts, and `index.dim` follows
`embedding.dim` unless the file pins it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class IndexConfig:
    """Device-resident vector index."""

    backend: str = "tpu"  # tpu | numpy (host parity backend)
    dim: int = 384
    metric: str = "cosine"
    dtype: str = "float32"  # storage dtype of full-precision vectors
    initial_capacity: int = 4096
    growth_factor: float = 2.0
    graph_degree: int = 16
    graph_ef_construction: int = 200
    graph_ef_runtime: int = 100
    use_graph: bool = False
    # memory tier: no fp32 vectors on the device, the rescore dequantizes int8
    store_fp32: bool = True
    # the JAX package's opt-in Pallas int8 stage 1; the port runs that
    # kernel's counterpart for either value (exact selection, as every
    # stage1_select policy does in the port: ROADMAP "Stage-1 select")
    use_pallas_scan: bool = False
    stage1_select: str = ""  # "" | f32 | bf16 | bf16_chunked | blockmax
    data_dir: str = "./data/index"
    auto_persist: bool = True
    docstore: str = "memory"  # memory | spill (spill: ROADMAP A10)
    docstore_cache_docs: int = 50_000


@dataclass(frozen=True)
class QuantizationConfig:
    """Binary / int8 quantization."""

    enabled: bool = True
    precision: str = "both"  # binary | int8 | both
    rescore_multiplier: float = 4.0
    use_rescoring: bool = True
    int8_ranges_path: str = ""  # optional .npy calibration artifact
    int8_on_disk_only: bool = False

    def validate(self) -> None:
        if self.precision not in ("binary", "int8", "both"):
            raise ValueError(f"invalid quantization precision: {self.precision}")
        if self.rescore_multiplier < 1.0:
            raise ValueError("rescore_multiplier must be >= 1.0")


@dataclass(frozen=True)
class BM25Config:
    """BM25 parameters, the impact sketch and the router's cost gate."""

    k1: float = 1.5
    b: float = 0.75
    index_path: str = "./data/bm25_index.json.gz"
    auto_save_threshold: int = 100
    max_query_terms: int = 32
    max_postings_per_query: int = 1 << 18
    sketch_dim: int = 1024  # 0 disables the sketch route
    sketch_hbm_budget_gb: float = 3.0
    disc_route_df_frac: float = 0.01
    pages_route_max_pages: int = 4096
    pages_route_max_cells: int = 1 << 30
    persist_max_docs: int = 200000  # above: no JSON, rebuild from the store
    auto_build: bool = True


@dataclass(frozen=True)
class RetrievalConfig:
    """Retrieval defaults."""

    dense_top_k: int = 10
    bm25_top_k: int = 10
    fused_top_k: int = 15
    rrf_k: int = 60
    min_similarity: float = 0.0
    search_scope: str = "leaves"  # leaves | parents | all
    retrieval_mode: str = "hybrid"  # hybrid | dense | bm25
    fusion_weighting: str = "auto"
    fused_depth: int = -1  # -1 = 4 x fused_top_k; 0 = off
    calibration_probes: int = 128
    calibration_paraphrase_fraction: float = 0.5
    calibration_seeds: int = 2


@dataclass(frozen=True)
class EmbeddingConfig:
    """Embedding model (bi-encoder)."""

    backend: str = "jax"  # jax (the built-in encoder) | openai_compatible
    model_name: str = "minilm-l12"
    weights_path: str = ""  # local HF weights; empty: shipped artifact or init
    preset: str = "auto"  # auto | trainable-small | none (resolved by config_from_dict)
    dim: int = 384
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 1536
    vocab_size: int = 30522
    max_seq_len: int = 256
    batch_size: int = 1024
    normalize: bool = True
    cache_size: int = 10000
    dtype: str = "bfloat16"
    # the JAX package's `train` output (orbax); the port raises when this
    # directory holds anything (ROADMAP queue A item 12)
    checkpoint_dir: str = "./data/embedder_ckpt"


@dataclass(frozen=True)
class CrossEncoderConfig:
    """Cross-encoder reranker (MiniLM-L12 class by default)."""

    backend: str = "jax"  # jax (the built-in encoder) | llm
    model_name: str = "minilm-l12-cross"
    weights_path: str = ""
    max_seq_len: int = 384
    batch_size: int = 32
    dtype: str = "bfloat16"
    dim: int = 384
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 1536
    vocab_size: int = 30522


@dataclass(frozen=True)
class CacheConfig:
    """LRU caches."""

    embedding_cache_size: int = 10000
    query_cache_size: int = 1000
    query_cache_ttl_s: float = 3600.0


@dataclass(frozen=True)
class IngestionConfig:
    """Chunking / ingest."""

    child_chunk_size: int = 512
    chunk_overlap: int = 50
    max_parent_chars: int = 50000
    embed_batch_size: int = 32
    # >= embedding.batch_size so each ingest embed call can fill the
    # embedder's batch
    upsert_batch_size: int = 2048
    hierarchical: bool = True
    use_intelligent_chunking: bool = False
    translate_at_ingestion: bool = False
    pdf_strategy: str = "auto"  # auto | fast | hi_res | ocr_only


@dataclass(frozen=True)
class MetricsConfig:
    prometheus_enabled: bool = False
    prometheus_port: int = 9090
    otel_enabled: bool = False
    otel_endpoint: str = ""


@dataclass(frozen=True)
class LoggingConfig:
    level: str = "INFO"
    file: str = ""
    color: bool = True


@dataclass(frozen=True)
class ServerConfig:
    """HTTP serving: concurrent /search requests arriving within
    `max_wait_ms` of each other are merged into one batch (`server.py`)."""

    host: str = "0.0.0.0"
    port: int = 8080
    coalesce: bool = True
    max_batch: int = 256  # peak queries folded into one batch
    max_wait_ms: float = 4.0
    # batches in flight in the coalescer (one batch's device->host fetch
    # overlaps the next batch's dispatch); 1 = sequential
    pipeline_depth: int = 2
    # requests allowed at once inside the HTTP host sections (JSON parse,
    # serialize + write); waiting in the coalescer holds no slot; 0 = no gate
    request_workers: int = 8


@dataclass(frozen=True)
class RerankConfig:
    """Cross-encoder rerank of the fused candidates (the rerank agent)."""

    enabled: bool = True
    top_k: int = 8
    candidate_multiplier: int = 4
    min_candidates: int = 16
    max_chars: int = 3000
    # final order = z(CE score) + prior_weight * z(incoming retrieval score)
    prior_weight: float = 1.0
    # measured auto-disable: self-retrieval probes price the CE blend
    # against the fused order it consumes; 0 probes disables the check
    auto_disable_probes: int = 64
    auto_disable_min_gain: float = 0.005


@dataclass(frozen=True)
class LLMConfig:
    """LLM chat backend."""

    backend: str = "openai_compatible"  # openai_compatible | mock | local (ROADMAP A11 rest)
    base_url: str = "http://localhost:11434/v1"
    api_key: str = "unused"
    model: str = "llama3.1"
    model_path: str = ""  # read only by backend "local"
    device: str = "cpu"  # read only by backend "local"
    temperature: float = 0.2
    max_tokens: int = 2048
    timeout_s: float = 120.0
    max_retries: int = 3
    retry_backoff_s: float = 1.0


@dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline feature flags."""

    use_planning: bool = True
    use_decomposition: bool = True
    use_rewrite: bool = True
    use_expansion: bool = True
    use_rrf: bool = True
    use_automerge: bool = True
    use_rerank: bool = True
    use_critic: bool = True
    use_web_search: bool = False
    use_multihop: bool = True
    use_context_eval: bool = True
    use_summarization: bool = True
    use_fact_verification: bool = True
    use_citation: bool = True
    use_tools: bool = True


@dataclass(frozen=True)
class AgenticConfig:
    """Critic retry loop."""

    max_critic_retries: int = 2
    confidence_threshold: float = 0.5
    give_up_confidence: float = 0.2
    simple_query_max_words: int = 10


@dataclass(frozen=True)
class QueryConfig:
    """Query processing limits."""

    max_decomposed_queries: int = 3
    max_expansions: int = 2
    max_rewrites: int = 3


@dataclass(frozen=True)
class SynthesisConfig:
    """Answer synthesis."""

    max_context_docs: int = 8
    max_chars_per_doc: int = 4000
    include_conversation_history: bool = True


@dataclass(frozen=True)
class CriticConfig:
    max_chars_per_doc: int = 1200
    max_docs: int = 6


@dataclass(frozen=True)
class ContextEvalConfig:
    enabled: bool = True
    use_llm: bool = False  # heuristic by default; LLM opt-in
    min_mean_score: float = 0.25
    min_docs: int = 1


@dataclass(frozen=True)
class SummarizationConfig:
    """Context compression."""

    max_total_context_chars: int = 8000
    max_doc_chars: int = 3000
    dedup_similarity: float = 0.85
    keep_recent_turns: int = 4


@dataclass(frozen=True)
class MultiHopConfig:
    enabled: bool = True
    max_hops: int = 3
    docs_per_hop: int = 4
    min_hop_confidence: float = 0.3


@dataclass(frozen=True)
class FactVerificationConfig:
    enabled: bool = True
    max_claims: int = 10
    correct_answer: bool = True
    min_overall_score: float = 0.5


@dataclass(frozen=True)
class CitationConfig:
    enabled: bool = True
    style: str = "inline"  # inline | footnote | academic | hyperlink | enterprise
    min_confidence: float = 0.3
    include_bibliography: bool = True


@dataclass(frozen=True)
class LanguageConfig:
    """Language detection + translation (ROADMAP A11 rest)."""

    enabled: bool = False
    canonical_language: str = "en"
    min_confidence: float = 0.5
    max_chars_per_llm_call: int = 4000


@dataclass(frozen=True)
class AutoMergeConfig:
    """Hierarchical auto-merge."""

    enabled: bool = True
    min_children_to_merge: int = 2
    max_parent_chars: int = 50000


@dataclass(frozen=True)
class WebSearchConfig:
    enabled: bool = False
    max_urls: int = 3
    cache_ttl_s: float = 3600.0
    blocked_domains: Tuple[str, ...] = ()
    trigger_keywords: Tuple[str, ...] = ("latest", "news", "today", "current", "recent")


@dataclass(frozen=True)
class WebCrawlerConfig:
    max_depth: int = 2
    max_pages: int = 50
    same_domain_only: bool = True
    rate_limit_delay_s: float = 0.5
    timeout_s: float = 20.0
    include_patterns: Tuple[str, ...] = ()
    exclude_patterns: Tuple[str, ...] = ()


@dataclass(frozen=True)
class GitHubConfig:
    token: str = ""
    max_files: int = 200
    include_extensions: Tuple[str, ...] = (".md", ".py", ".txt", ".rst")


@dataclass(frozen=True)
class ConversationConfig:
    enabled: bool = True
    max_turns: int = 20
    ttl_s: float = 86400.0
    data_dir: str = "./data/conversations"


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh / sharding; read only by `index.backend: sharded`
    (ROADMAP A12). Axis sizes of -1 mean "all remaining devices"."""

    data_axis: int = -1
    model_axis: int = 1
    shard_corpus: bool = False
    dtype_compute: str = "bfloat16"


@dataclass(frozen=True)
class StrategyMemoryConfig:
    enabled: bool = True
    path: str = "./data/strategy_memory.json.gz"
    decay: float = 0.95
    min_confidence: float = 0.6


@dataclass(frozen=True)
class ToolsConfig:
    enabled: bool = True
    allow_code_execution: bool = False


@dataclass(frozen=True)
class ReportConfig:
    default_format: str = "markdown"
    include_metrics: bool = True


@dataclass(frozen=True)
class AppConfig:
    """Every section, in the JAX package's order."""

    index: IndexConfig = field(default_factory=IndexConfig)
    quantization: QuantizationConfig = field(default_factory=QuantizationConfig)
    bm25: BM25Config = field(default_factory=BM25Config)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    rerank: RerankConfig = field(default_factory=RerankConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    cross_encoder: CrossEncoderConfig = field(default_factory=CrossEncoderConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    agentic: AgenticConfig = field(default_factory=AgenticConfig)
    query: QueryConfig = field(default_factory=QueryConfig)
    synthesis: SynthesisConfig = field(default_factory=SynthesisConfig)
    critic: CriticConfig = field(default_factory=CriticConfig)
    context_eval: ContextEvalConfig = field(default_factory=ContextEvalConfig)
    summarization: SummarizationConfig = field(default_factory=SummarizationConfig)
    multihop: MultiHopConfig = field(default_factory=MultiHopConfig)
    fact_verification: FactVerificationConfig = field(default_factory=FactVerificationConfig)
    citation: CitationConfig = field(default_factory=CitationConfig)
    language: LanguageConfig = field(default_factory=LanguageConfig)
    ingestion: IngestionConfig = field(default_factory=IngestionConfig)
    automerge: AutoMergeConfig = field(default_factory=AutoMergeConfig)
    web_search: WebSearchConfig = field(default_factory=WebSearchConfig)
    web_crawler: WebCrawlerConfig = field(default_factory=WebCrawlerConfig)
    github: GitHubConfig = field(default_factory=GitHubConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    conversation: ConversationConfig = field(default_factory=ConversationConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    strategy_memory: StrategyMemoryConfig = field(default_factory=StrategyMemoryConfig)
    tools: ToolsConfig = field(default_factory=ToolsConfig)
    report: ReportConfig = field(default_factory=ReportConfig)
    server: ServerConfig = field(default_factory=ServerConfig)


_SECTIONS = {f.name: f.default_factory for f in fields(AppConfig)}
ENV_PREFIX = "RADIANT"
_NEITHER = "read by neither package"
_GRAPH = "the graph engine, ROADMAP queue A item 10"
_REST = "ROADMAP queue A item 11 (rest)"
_EXPORTER = f"the metrics exporter (utils/metrics_export.py) is not ported yet, {_REST}"
_REMOTE = f"only the non-jax backends (llm/model_backends.py) read it, {_REST}"
_LOCAL_LLM = ("only llm.backend 'local' reads it, which waits for causal-LM weights in the "
              f"repository, {_REST}")
_WEB = f"web search and the crawlers are not ported yet, {_REST}"
_PARALLEL = "the sharded corpus, ROADMAP queue A item 12"
# Fields parsed for parity that the port has no behaviour for: a value
# other than the default raises, with the reason. A section named by a
# string has no behaviour in any field.
_NOT_PORTED = {
    "index": {"metric": _NEITHER + " (cosine only)",
              "growth_factor": _NEITHER + " (the engine grows by CAPACITY_QUANTUM)",
              "graph_degree": _GRAPH, "graph_ef_construction": _GRAPH,
              "docstore_cache_docs": "the spill docstore, ROADMAP queue A item 10"},
    "quantization": {"int8_on_disk_only": _NEITHER},
    "embedding": {"backend": _REMOTE, "model_name": _REMOTE},
    "cross_encoder": {"backend": _REMOTE, "model_name": _NEITHER},
    "llm": {"model_path": _LOCAL_LLM, "device": _LOCAL_LLM},
    "pipeline": {"use_web_search": _WEB},
    "agentic": {"simple_query_max_words": _NEITHER + " (the simple-query rule is fixed)"},
    "query": {"max_rewrites": _NEITHER},
    "language": {"enabled": "language detection and translation (agents/language.py) are "
                            f"not ported yet, {_REST}"},
    "ingestion": {"embed_batch_size": _NEITHER, "use_intelligent_chunking": _NEITHER,
                  "translate_at_ingestion": _NEITHER},
    "web_search": _WEB,
    "web_crawler": _WEB,
    "github": _WEB,
    "metrics": {"prometheus_enabled": _EXPORTER, "prometheus_port": _EXPORTER,
                "otel_enabled": _EXPORTER, "otel_endpoint": _EXPORTER},
    "mesh": {"shard_corpus": _PARALLEL, "dtype_compute": _NEITHER},
    "report": f"the reports (ui/) are not ported yet, {_REST}; the JAX package reads "
              "no field of it either",
    "server": {"host": _NEITHER + " (the serve command's --host)",
               "port": _NEITHER + " (the serve command's --port)"},
}
# the JAX package's "trainable-small" preset: the shape of the shipped
# 128 x 6 bi-encoder and cross-encoder artifacts
_TRAINABLE_SMALL = {"dim": 128, "num_layers": 6, "num_heads": 4, "hidden_dim": 256,
                    "vocab_size": 8192, "max_seq_len": 64}
_TRAINABLE_SMALL_CE = {"dim": 128, "num_layers": 6, "num_heads": 4, "hidden_dim": 256,
                       "vocab_size": 8192, "max_seq_len": 128}


_TYPES = {"bool": bool, "int": int, "float": float, "str": str,
          "Tuple[str, ...]": Tuple[str, ...]}


def _coerce(value: Any, ftype: Any) -> Any:
    """A YAML or environment value as a field's type (the JAX package's
    rules: a list, or a comma-separated string, becomes a tuple)."""
    if ftype == Tuple[str, ...]:
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        return tuple(str(v) for v in value)
    if ftype is bool:
        if isinstance(value, bool):
            return value
        return str(value).strip().lower() in ("1", "true", "yes", "on")
    return ftype(value)


def _section(cls: type, data: Dict[str, Any], name: str) -> Any:
    """One section: its environment overrides, else the file's values,
    else the defaults."""
    kwargs = {}
    for f in fields(cls):
        env_key = f"{ENV_PREFIX}_{name}_{f.name}".upper()
        if env_key in os.environ:
            kwargs[f.name] = _coerce(os.environ[env_key], _TYPES[f.type])
        elif f.name in data:
            kwargs[f.name] = _coerce(data[f.name], _TYPES[f.type])
    unknown = set(data) - {f.name for f in fields(cls)}
    if unknown:
        logger.warning("config section %s: unknown keys ignored: %s", name, sorted(unknown))
    section = cls(**kwargs)
    reasons = _NOT_PORTED.get(name, {})
    if isinstance(reasons, str):
        reasons = {f.name: reasons for f in fields(cls)}
    for key, reason in reasons.items():
        if getattr(section, key) != getattr(cls, key):
            raise NotImplementedError(f"config {name}.{key}={getattr(section, key)!r}: the "
                                      f"port has no behaviour for it; {reason}")
    return section


def _apply_embedding_preset(sections: Dict[str, Any], data: Dict[str, Any]) -> None:
    """embedding.preset as the JAX package resolves it (module doc): the
    keys the file sets win over the preset."""
    emb = sections["embedding"]
    preset = emb.preset
    if preset == "auto":
        preset = "trainable-small" if emb.backend == "jax" and not emb.weights_path else "none"
    if preset in ("none", ""):
        return
    if preset != "trainable-small":
        logger.warning("unknown embedding.preset %r ignored", preset)
        return

    def explicit(name):  # the fields the file or the environment sets
        prefix = f"{ENV_PREFIX}_{name}_".upper()
        return set(data.get(name) or {}) | {k[len(prefix):].lower() for k in os.environ
                                            if k.startswith(prefix)}

    sections["embedding"] = replace(emb, **{k: v for k, v in _TRAINABLE_SMALL.items()
                                            if k not in explicit("embedding")})
    if "dim" not in explicit("index"):
        sections["index"] = replace(sections["index"], dim=sections["embedding"].dim)
    ce = sections["cross_encoder"]
    if not ce.weights_path:
        sections["cross_encoder"] = replace(ce, **{k: v for k, v in _TRAINABLE_SMALL_CE.items()
                                                   if k not in explicit("cross_encoder")})


def config_from_dict(data: Optional[Dict[str, Any]]) -> AppConfig:
    """AppConfig from a parsed YAML document: defaults, then the file's
    values, then the `RADIANT_<SECTION>_<FIELD>` environment overrides, then
    the embedding preset (module doc). A section name no section has is
    logged and ignored."""
    data = data or {}
    unknown = set(data) - set(_SECTIONS)
    if unknown:
        logger.warning("config: unknown sections ignored: %s", sorted(unknown))
    sections = {name: _section(cls, data.get(name) or {}, name)
                for name, cls in _SECTIONS.items()}
    _apply_embedding_preset(sections, data)
    cfg = AppConfig(**sections)
    cfg.quantization.validate()
    return cfg


def load_config(path: str) -> AppConfig:
    """AppConfig from a YAML file. Raises when the file is missing or does
    not parse, and when PyYAML is not installed: a configuration that
    cannot be read is never replaced by the defaults."""
    try:
        import yaml
    except ImportError as exc:
        raise RuntimeError(f"load_config({path!r}) needs PyYAML, which is not installed; "
                           "build the configuration with config_from_dict") from exc
    with open(path) as fh:
        data = yaml.safe_load(fh)
    if data is not None and not isinstance(data, dict):
        raise ValueError(f"{path}: a configuration is a mapping of sections, "
                         f"got {type(data).__name__}")
    return config_from_dict(data)
