"""BENCHMARK.json against the contract's shape, and every file it names found."""

import json
import re

import pytest

from pbcore import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics_shape():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = spec.Cell(name)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.driver(), "Driver")
    readers = c.metric_readers()
    assert readers, "a cell reports at least one per-layer metric"
    for _, mod in readers:
        assert callable(mod.read)
    assert c.end_to_end and {"setup_s"} < {m["name"] for m in c.end_to_end}


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert (spec.ROOT / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((spec.CHECKOUT / cfg["file"]).read_text())
    assert cfg["file"].startswith("portbench/")
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    widths = ("hidden_size", "intermediate_size", "num_attention_heads", "vocab_size", "dim")
    assert not set(cfg["reduced"]) & set(widths)
    for k in cfg["reduced"]:
        assert k in data["published"] and data[k] != data["published"][k]
