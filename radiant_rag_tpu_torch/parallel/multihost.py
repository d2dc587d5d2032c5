"""Multi-process bring-up on `torch.distributed`.

The port's counterpart of `radiant_rag_tpu/parallel/multihost.py`. Scaling
past one host keeps the corpus ('data') axis on each host's own devices and
puts a 'replica' axis across processes: each process holds and scans only
its slice of the corpus (`host_shard_bounds`), and only the final (B, k)
top-k crosses processes (`merge_across_processes`, the JAX DCN worker's
all-gather + top-k).

Nothing tells a process of its cluster here: the caller passes the
coordinator's host:port, the process count and its rank. The group runs
over `tcp://` with NCCL, or gloo when the caller asks for the CPU.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from radiant_rag_tpu_torch.parallel.mesh import Mesh, _grid, visible_cuda_devices
from radiant_rag_tpu_torch.parallel.sharded_index import merge_topk

logger = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group at `coordinator_address` (host:port) as rank
    `process_id` of `num_processes`. Returns True when more than one
    process is in the group. Without a coordinator the run is one process
    and this returns False. device="cpu" selects gloo, anything else NCCL
    (each rank on cuda:<local rank>). A failure to join raises."""
    if coordinator_address is None:
        return dist.is_initialized() and dist.get_world_size() > 1
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        devs = visible_cuda_devices()
        torch.cuda.set_device(devs[int(process_id or 0) % len(devs)])
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes or 1), rank=int(process_id or 0))
    logger.info("torch.distributed initialized: process %d/%d (%s)", dist.get_rank(),
                dist.get_world_size(), dist.get_backend())
    return dist.get_world_size() > 1


def _rank_and_size(process_id: Optional[int], num_processes: Optional[int]) -> Tuple[int, int]:
    live = dist.is_initialized()
    p = process_id if process_id is not None else (dist.get_rank() if live else 0)
    n = num_processes if num_processes is not None else (dist.get_world_size() if live else 1)
    return p, max(n, 1)


def host_shard_bounds(n_rows: int, process_id: Optional[int] = None,
                      num_processes: Optional[int] = None) -> Tuple[int, int]:
    """[start, end) corpus rows this process loads: contiguous slices, the
    remainder rows to the leading processes. Defaults read the process
    group; one process gets the full range."""
    p, n = _rank_and_size(process_id, num_processes)
    base, rem = divmod(n_rows, n)
    start = p * base + min(p, rem)
    return start, start + base + (1 if p < rem else 0)


def create_multihost_mesh(corpus_axis_per_host: bool = True, device=None,
                          local_devices: Optional[int] = None) -> Mesh:
    """A ('replica', 'data') mesh: one row per process, each row this
    process's local devices (every visible CUDA device, or `local_devices`
    logical shards of the CPU when device="cpu"), and `processes` naming
    the rank of every entry. With one process, or corpus_axis_per_host
    False, one row."""
    if device is not None and torch.device(device).type == "cpu":
        local = [torch.device("cpu")] * int(local_devices or 1)
    else:
        local = visible_cuda_devices()[: local_devices or None]
    _, n_proc = _rank_and_size(None, None)
    rows = n_proc if corpus_axis_per_host and n_proc > 1 else 1
    devices = _grid(local * rows, (rows, len(local)))
    owners = np.repeat(np.arange(rows), len(local)).reshape(rows, len(local))
    return Mesh(devices, ("replica", "data"), processes=owners)


def merge_across_processes(scores: torch.Tensor, rows: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (B, k) scores and global rows gathered with
    `all_gather_into_tensor`, in rank order, then the top-k (ties to the
    lower rank): the merged (B, k) on every rank."""
    world = dist.get_world_size()
    b, kk = scores.shape
    all_s = torch.empty((world * b, kk), dtype=scores.dtype, device=scores.device)
    all_i = torch.empty((world * b, kk), dtype=rows.dtype, device=rows.device)
    dist.all_gather_into_tensor(all_s, scores.contiguous())
    dist.all_gather_into_tensor(all_i, rows.contiguous())
    return merge_topk(list(all_s.view(world, b, kk)), list(all_i.view(world, b, kk)), k,
                      scores.device)
