"""The encoders: embedding bi-encoder and cross-encoder reranker.

Counterpart of `radiant_rag_tpu/models/`: MiniLM-class BERT modules in
PyTorch (`bert.py`), the tokenizers (`tokenizer.py`), the `Embedder` with
its device hand-off to retrieval, the `CrossEncoder` and the
`DeviceReranker` over a device token table, the weight loaders
(`pretrained.py`, `hf_loading.py`) and the `LocalNLPModels` facade.
"""
