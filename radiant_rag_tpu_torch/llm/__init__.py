"""LLM chat layer: robust JSON parsing, retrying client, pluggable backends.

The port's copy of `radiant_rag_tpu/llm/` (host-side, no device work): the
agent loop is control flow around LLM HTTP calls.
"""

from radiant_rag_tpu_torch.llm.json_parser import JSONParser  # noqa: F401
from radiant_rag_tpu_torch.llm.client import LLMClient  # noqa: F401
from radiant_rag_tpu_torch.llm.backends import (  # noqa: F401
    BaseLLMBackend, LLMError, MockLLMBackend, OpenAICompatibleLLMBackend, create_llm_backend,
)
