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
new = {"config", "index.base", "index.doc", "index.docstore", "index.factory",
       "index.numpy_store", "index.store"}
assert {"radiant_rag_tpu_torch." + m for m in new} <= set(names), names
import torch
assert not torch.cuda.is_available()
from radiant_rag_tpu_torch.config import config_from_dict
from radiant_rag_tpu_torch.index.bm25 import BM25Index, PersistentBM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.factory import create_vector_store
from radiant_rag_tpu_torch.index.store import TpuVectorStore
for make in (lambda: DeviceVectorIndex(64), lambda: BM25Index(),
             lambda: DeviceVectorIndex(64, device="cuda"), lambda: TpuVectorStore(64),
             lambda: create_vector_store(config_from_dict({})),
             lambda: PersistentBM25Index(None)):
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


def test_load_config_raises_instead_of_serving_defaults(tmp_path, caplog):
    """The JAX package's load_config warns and serves the defaults when a
    file does not parse; the port's raises, so no other configuration runs."""
    from radiant_rag_tpu_torch.config import load_config

    bad = tmp_path / "bad.yaml"
    bad.write_text("index: [unclosed\n  store_fp32: false\n")
    with pytest.raises(Exception) as info:
        load_config(str(bad))
    assert "yaml" in type(info.value).__module__.lower() or "YAML" in str(info.value)
    assert not [r for r in caplog.records if r.levelname == "WARNING"]
    with pytest.raises(FileNotFoundError):
        load_config(str(tmp_path / "missing.yaml"))
    scalar = tmp_path / "scalar.yaml"
    scalar.write_text("just a string\n")
    with pytest.raises(ValueError, match="mapping"):
        load_config(str(scalar))
