"""Worker process of tests/test_torch_multihost.py.

    python tests/_torch_dist_worker.py <host:port> <num_processes> <process_id>

Joins a gloo process group over tcp on localhost and checks the port's
multi-process bring-up (`parallel/multihost.py`), as tests/dcn_worker.py
does for the JAX package:

1. initialize_multihost         -> True, the group has num_processes ranks
2. create_multihost_mesh        -> ('replica', 'data') = (processes, 4 logical
                                   cpu shards), row p owned by rank p
3. host_shard_bounds            -> disjoint contiguous slices of the corpus
4. merge_across_processes       -> each rank searches only its slice (a
                                   ShardedFlatIndex over its 4 shards, exact
                                   mode), its rows made global; the merged
                                   top-k equals a full-corpus oracle

Prints one line "DIST_OK <json>" on success; a failed check exits non-zero.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from radiant_rag_tpu_torch.parallel.mesh import create_mesh, mesh_info
from radiant_rag_tpu_torch.parallel.multihost import (
    create_multihost_mesh, host_shard_bounds, initialize_multihost, merge_across_processes,
)
from radiant_rag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

N_DOCS, DIM, K, LOCAL = 512, 64, 8, 4


def main() -> None:
    coordinator, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    assert initialize_multihost(coordinator, n_proc, pid, device="cpu")
    assert dist.get_world_size() == n_proc and dist.get_rank() == pid
    mesh = create_multihost_mesh(device="cpu", local_devices=LOCAL)
    assert mesh_info(mesh) == {"replica": n_proc, "data": LOCAL}, mesh_info(mesh)
    assert all(set(mesh.processes[row]) == {row} for row in range(n_proc))

    lo, hi = host_shard_bounds(N_DOCS)
    rng = np.random.default_rng(7)  # the full corpus, the same on every rank
    full = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    full /= np.linalg.norm(full, axis=1, keepdims=True)
    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    local = ShardedFlatIndex(create_mesh(LOCAL, 1, devices=["cpu"] * LOCAL), full[lo:hi])
    s, rows = local.search(queries, K, mode="exact")
    ms, mi = merge_across_processes(torch.from_numpy(s), torch.from_numpy(rows + lo), K)
    oracle = queries @ full.T
    oi = np.argsort(-oracle, axis=1)[:, :K]
    assert np.array_equal(mi.numpy(), oi), (mi[0], oi[0])
    np.testing.assert_allclose(ms.numpy(), np.take_along_axis(oracle, oi, axis=1), rtol=1e-5)
    print("DIST_OK " + json.dumps({"pid": pid, "bounds": [lo, hi], "mesh": mesh_info(mesh),
                                   "top1_row": int(mi[0, 0])}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
