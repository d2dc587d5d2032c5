"""A whole run of each cell, cut to a tiny size on the CPU: the result
line's schema, and `correct` false when the timed path is broken
underneath (one answer altered where it is produced; half of the batch
left out; the reranked order altered; the dense leg left out of the
fusion), and the control's numbers past a limit."""

import json

import numpy as np
import pytest
import torch

from pbcore import spec
import tiny  # noqa: E402  (portbench/tests, on the path by conftest)

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    return request.param, tiny.run(request.param)


def test_result_line_schema(sound):
    name, out = sound
    line = json.loads(json.dumps(out.line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compare"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = spec.Cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0  # no card: peak_gib 0
    assert set(line["compare"]) == set(cell.limits)
    for c in line["compare"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_has_device_window():
    out = tiny.run(CELLS[0], traced=True)
    dev = out.line["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    assert set(out.line["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_answer(driver):
    """Every query's first fused row replaced by the next row."""
    searcher = driver.system.searcher
    orig = searcher.search_rows

    def altered(res):
        s, r = res["fused"]
        r = r.copy()
        r[:, 0] = (r[:, 0] + 1) % driver.system.engine.count
        return {**res, "fused": (s, r)}

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        if kw.get("fetch", True):
            return altered(out)
        packed, unpack = out
        return packed, lambda: altered(unpack())

    searcher.search_rows = wrapped


def _half_batch(driver):
    """Only the first half of each batch searched; the rest left empty."""
    searcher = driver.system.searcher
    orig = searcher.search_rows

    def emptied(res, b):
        out = {}
        for leg, (s, r) in res.items():
            s, r = s.copy(), r.copy()
            s[b // 2:], r[b // 2:] = -1e30, -1
            out[leg] = (s, r)
        return out

    def wrapped(q, texts, *a, **kw):
        b = len(texts)
        out = orig(q, texts, *a, **kw)
        if kw.get("fetch", True):
            return emptied(out, b)
        packed, unpack = out
        return packed, lambda: emptied(unpack(), b)

    searcher.search_rows = wrapped


def _swap_rerank(driver):
    """The reranked list's first two rows swapped (the rerank's answer altered)."""
    rr = driver.system.reranker
    orig = rr.rerank_rows

    def wrapped(*a, **kw):
        s, r = orig(*a, **kw)
        s, r = s.copy(), r.copy()
        s[:, [0, 1]], r[:, [0, 1]] = s[:, [1, 0]], r[:, [1, 0]]
        return s, r

    rr.rerank_rows = wrapped


def _fusion_without_dense(driver):
    """The fused list made from the BM25 leg alone (the dense rows dropped
    on their way into the fusion); both legs still returned as computed."""
    from radiant_rag_tpu_torch.index import hybrid

    searcher = driver.system.searcher
    orig, fuse = searcher.search_rows, hybrid._fuse_stage

    def no_dense(dense_i, bm_i, *a, **kw):
        return fuse(torch.full_like(dense_i, -1), bm_i, *a, **kw)

    def wrapped(*a, **kw):
        hybrid._fuse_stage = no_dense
        try:
            return orig(*a, **kw)
        finally:
            hybrid._fuse_stage = fuse

    searcher.search_rows = wrapped


def _dense_fused(name):
    """Cells whose corpus vectors are the embedder's, so the calibration
    gives the dense leg a real share of the fusion."""
    return spec.Cell(name).config.get("corpus_vectors") == "encoder"


FAULTS = [(c, f) for c in CELLS for f in (_alter_answer, _half_batch)] + \
    [(c, _swap_rerank) for c in CELLS if "rerank" in c] + \
    [(c, _fusion_without_dense) for c in CELLS if _dense_fused(c)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(name, fault):
    out = tiny.run(name, fault=fault)
    assert out.line["correct"] is False, out.compare


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_number(name):
    """The reference one precision lower, in the port's place, reads past
    a limit of the cell (at this size; the cell's own readings are in
    PERF.md)."""
    out = tiny.run(name, control=True)
    limits = spec.Cell(name).limits
    ctl = out.line["control"]
    assert {k: c["limit"] for k, c in ctl.items()} == limits
    assert any(c["value"] > c["limit"] for c in ctl.values()), ctl
    assert out.line["control_correct"] is False
    assert np.isfinite([c["value"] for c in ctl.values()]).all()
    assert list(out.line)[-1] == "compare"
