"""The plain reference of the benchmark's cells.

Plain PyTorch and NumPy, float32 with TF32 off (float64 where it says so).
It imports neither JAX nor anything of the port: it works out again, from
the inputs the harness made (corpus vectors and words, query texts and
vectors, model weights), what the port derives in set-up and on its timed
path: the encoders' outputs, the int8 ranges and codes, the sign words, the
BM25 tables and impact sketch, both retrieval legs, the fusion and the
rerank blend. `Precision` names the arithmetic of each stage; the control
that a comparison must fail is this same reference one precision lower.
"""
