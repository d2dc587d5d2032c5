"""Import hygiene of the PyTorch port: it imports neither jax nor any module
of the JAX package, and its entry points refuse to fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import radiant_rag_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "radiant_rag_tpu" or m.startswith("radiant_rag_tpu.")]
assert not bad, bad
assert len(names) >= 12, names
import torch
assert not torch.cuda.is_available()
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
for make in (lambda: DeviceVectorIndex(64), lambda: BM25Index(),
             lambda: DeviceVectorIndex(64, device="cuda")):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise AssertionError("an entry point fell back to the CPU")
DeviceVectorIndex(64, device="cpu")
print("ok", len(names))
"""


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted((REPO / "radiant_rag_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_name_no_jax_import(path):
    """Static check as well: no port module imports jax or the JAX package
    (the port's own name starts with radiant_rag_tpu, hence the dot)."""
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            mod = words[1].rstrip(",")
            assert mod != "jax" and not mod.startswith("jax."), line
            assert mod != "radiant_rag_tpu" and not mod.startswith("radiant_rag_tpu."), line
