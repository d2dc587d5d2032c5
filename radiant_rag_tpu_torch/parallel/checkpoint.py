"""Training checkpoints in the port's own format.

Counterpart of `radiant_rag_tpu/parallel/checkpoint.py`, whose
`TrainCheckpointer` is orbax's `CheckpointManager`. The port needs no
orbax: a step is one directory, `<directory>/<step>/`, written under a
temporary name and renamed once complete, so a step directory that exists
is whole (orbax's finalize does the same). It holds

  params.npz  the float32 params under their flax tree paths
              (`layer_0/attention/query/kernel`, Dense kernels as (in, out)),
  mu.npz      AdamW's first moment, keyed and laid out as the params,
  nu.npz      AdamW's second moment, likewise,
  meta.json   the format tag, the step, AdamW's count and the schedule
              (learning rate, schedule steps),

all read back with `np.load(allow_pickle=False)` and `json`: nothing is
unpickled. The newest `max_to_keep` steps are kept. A state on a mesh is
saved whole (its shards gathered, `TrainState.params` / `moments`), so a
step written on one mesh restores into a state on any other.

A step directory the JAX package's orbax manager wrote has no meta.json;
`restore` raises `NotImplementedError` for it, naming the conversion
(`convert.embedder_checkpoint_from_jax`).
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np

from radiant_rag_tpu_torch.convert import params_from_flat, params_to_flat

FORMAT = "radiant_rag_tpu_torch/train_checkpoint/1"
ORBAX_NOT_READ = (
    "{path} is not a checkpoint of the PyTorch port (no meta.json): an orbax "
    "checkpoint of the JAX package? Restore it there (radiant_rag_tpu.parallel."
    "checkpoint.TrainCheckpointer(dir).restore()['params']) and write it for the "
    "port with radiant_rag_tpu_torch.convert.embedder_checkpoint_from_jax")


def _save_npz(path: Path, arrays: Mapping[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        np.savez(f, **{k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()})


def _load_npz(path: Path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class TrainCheckpointer:
    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state) -> None:
        """A `parallel.train.TrainState`'s params, moments, count and
        schedule as step `step`."""
        mu, nu = state.moments()
        self.save_arrays(step, params_to_flat(state.model, state.params),
                         mu=params_to_flat(state.model, mu), nu=params_to_flat(state.model, nu),
                         count=state.step,
                         schedule={"learning_rate": state.learning_rate,
                                   "schedule_steps": state.schedule_steps})

    def save_arrays(self, step: int, params: Mapping[str, np.ndarray],
                    mu: Optional[Mapping[str, np.ndarray]] = None,
                    nu: Optional[Mapping[str, np.ndarray]] = None, count: int = 0,
                    schedule: Optional[Mapping[str, Any]] = None) -> None:
        """Flax-path arrays as step `step` (moments default to zeros)."""
        tmp = self.directory / f".tmp-{step}-{uuid.uuid4().hex}"
        tmp.mkdir()
        try:
            zeros = {k: np.zeros_like(v, np.float32) for k, v in params.items()}
            _save_npz(tmp / "params.npz", params)
            _save_npz(tmp / "mu.npz", mu if mu is not None else zeros)
            _save_npz(tmp / "nu.npz", nu if nu is not None else zeros)
            (tmp / "meta.json").write_text(json.dumps(
                {"format": FORMAT, "step": int(step), "count": int(count),
                 "schedule": dict(schedule or {})}))
            final = self.directory / str(int(step))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def all_steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template=None):
        """Step `step` (default: the latest; None when there is none) as
        {"params", "opt_state": {"mu", "nu", "count"}, "step", "schedule"}
        with flax-path numpy leaves, or, given a TrainState `template`,
        loaded into it (params, moments, count) and returned."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = self.directory / str(int(step))
        meta_path = d / "meta.json"
        if not meta_path.is_file():
            raise NotImplementedError(ORBAX_NOT_READ.format(path=d))
        meta = json.loads(meta_path.read_text())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{d}: format {meta.get('format')!r}, expected {FORMAT!r}")
        params, mu, nu = (_load_npz(d / f"{name}.npz") for name in ("params", "mu", "nu"))
        if template is not None:
            return template.load(params_from_flat(params), params_from_flat(mu),
                                 params_from_flat(nu), meta["count"])
        return {"params": params, "opt_state": {"mu": mu, "nu": nu, "count": meta["count"]},
                "step": meta["step"], "schedule": meta["schedule"]}
