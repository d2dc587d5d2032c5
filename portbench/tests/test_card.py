"""Each cell once on the card, through the command BENCHMARK.json names,
with a short window: its last line parses, `correct` holds, the device is
the card. Skips without a card (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from pbcore import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels have no CPU mode")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    cmd = spec.benchmark()["command"] + ["--workload", name, "--seed", str(2**31 + 77),
                                         "--seconds", "3", "--trace", "0"]
    out = subprocess.run(cmd, cwd=spec.CHECKOUT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compare"]
    assert line["device"]["kind"] == card and line["device"]["platform"] == "gpu"
