"""Finds a cell's files by the names in BENCHMARK.json.

  configs/<config>.json     the deployment: source, cuts, assumed sizes and
                            the port's config dict (`program_config`)
  traffic/<mix>.json        batch, in flight, query form, its driver's name,
                            its `stages` (absent: none)
  drivers/<driver>.py       builds the system and drives one request
  stages/<stage>.py         a part of the timed path the built-in stages do
                            not cover (a model the harness has not met):
                              SPANS      the harness spans its driver opens
                              build(system, config, traffic, seed, device)
                                         in set-up, after the system and
                                         before the driver: draws its
                                         weights (data.generator(device,
                                         seed, "weights.<stage>")) and puts
                                         what it builds in
                                         system.stages[<stage>]
                              work(config, traffic) -> {stage: [Item]}
                                         its counted work of one request
                                         (work/counts.py), for mfu and
                                         readers.roofline
                              judge(world, batch, out) -> {number: value}
                                         after the built-in numbers, the
                                         port's state freed: the reference
                                         of its outputs, its own weights
                                         drawn again
                              outputs(world, batch, prec) -> {key: output}
                                         the reference in the port's place
                                         at `prec` (the control)
  metrics/<metric>.py       reads one per-layer metric (`read(run)`)
  limits/<cell>.json        the limit of each number `correct` compares;
                            a number without one stops the run

A later cell, configuration, mix, stage or metric is new files and
entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]  # portbench/
CHECKOUT = ROOT.parent


def benchmark() -> Dict:
    with open(CHECKOUT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, bench: Dict = None) -> None:
        bench = bench if bench is not None else benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(CHECKOUT / self.config_entry["file"])
        self.traffic = _json(ROOT / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(ROOT / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.reports(m)]

    def reports(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return load_module(ROOT / "drivers" / f"{name}.py", f"portbench_driver_{name}")

    def stages(self) -> List[ModuleType]:
        return [load_module(ROOT / "stages" / f"{name}.py", f"portbench_stage_{name}")
                for name in self.traffic.get("stages", [])]

    def metric_readers(self) -> List:
        return [(m, load_module(ROOT / "metrics" / f"{m['name']}.py",
                                f"portbench_metric_{m['name'].replace('.', '_')}"))
                for m in self.per_layer]
