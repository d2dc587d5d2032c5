"""What the harness loads: never JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port."""

import ast
import subprocess
import sys

from pbcore import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "radiant_rag_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for f in spec.ROOT.rglob("*.py"):
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in (spec.ROOT / "reference").rglob("*.py"):
        names = set(_imports(f))
        assert "radiant_rag_tpu_torch" not in names and not names & FORBIDDEN, f
        assert names <= {"__future__", "contextlib", "dataclasses", "math", "re", "typing",
                         "numpy", "torch", "reference"}, (f, names)


def test_harness_loads_no_jax_at_run_time():
    """A tiny CPU run in a fresh process, then its loaded modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import tiny\n"
        "tiny.run('int8-text-b2048')\n"
        "from pbcore.cell import forbidden_modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r), forbidden_modules())\n"
    ) % (str(spec.CHECKOUT), str(spec.ROOT), str(spec.ROOT / "tests"), FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"
