"""The port's multi-process bring-up (`parallel/multihost.py`) in two gloo
processes on the CPU, the counterpart of tests/test_multihost.py's two
jax.distributed processes: each rank runs tests/_torch_dist_worker.py,
searches only its slice of the corpus, and the cross-process merge must
equal a full-corpus oracle on both ranks."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from radiant_rag_tpu.parallel.multihost import host_shard_bounds as jax_host_shard_bounds
from radiant_rag_tpu_torch.parallel.multihost import (
    create_multihost_mesh, host_shard_bounds, initialize_multihost,
)

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_merge_matches_the_oracle():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    worker = REPO / "tests" / "_torch_dist_worker.py"
    procs = [subprocess.Popen([sys.executable, str(worker), coordinator, "2", str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(REPO))
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    payloads = {}
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        line = [x for x in out.splitlines() if x.startswith("DIST_OK ")]
        assert line, out
        payloads[pid] = json.loads(line[-1][len("DIST_OK "):])
    assert payloads[0]["bounds"] == [0, 256] and payloads[1]["bounds"] == [256, 512]
    assert payloads[0]["mesh"] == {"replica": 2, "data": 4}
    assert payloads[0]["top1_row"] == payloads[1]["top1_row"]


def test_single_process_bring_up_matches_jax():
    assert initialize_multihost() is False  # no coordinator: one process
    assert host_shard_bounds(1000) == (0, 1000) == jax_host_shard_bounds(1000)
    for n, procs in ((1003, 4), (1037, 4), (7, 3), (0, 2)):
        spans = [host_shard_bounds(n, p, procs) for p in range(procs)]
        assert spans == [jax_host_shard_bounds(n, p, procs) for p in range(procs)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(spans[i][1] == spans[i + 1][0] for i in range(procs - 1))
    mesh = create_multihost_mesh(device="cpu", local_devices=4)
    assert mesh.axis_names == ("replica", "data") and mesh.shape == (1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_multihost_mesh()
