"""Agent layer: the host-side multi-agent query pipeline of the port.

The agents that `RAGOrchestrator.run` reaches under the default pipeline
config, copied from `radiant_rag_tpu/agents/` with their behaviour. Their
device calls (embed, store search, BM25 search, cross-encoder) are device
stages (`base_agent.DeviceStages`): serialized with the server's searches
and raised, never degraded. Also here: language detection and translation
(phase 0), web search, intelligent chunking (a library class), the agent
registry and the agent template.
"""
