"""A cell whose model the harness has never met enters as new files only.

A copy of portbench/ and BENCHMARK.json gains one cell, `int8-text-mlp`:
the int8 text hybrid of `int8-text-b2048` with a toy stage after the
search, a seeded two-layer MLP that scores the fused rows' passage words
(float32 on the port's side, a float64 plain reference in the judge, the
control in fp8). Every file the cell needs is new: its traffic, driver,
stage, metric, limits and its entries in BENCHMARK.json. The copy is run
through `tiny.run` on the CPU in a process of its own, and:

  * `correct` holds and the stage's number is compared;
  * an answer of the stage altered where it is produced is not correct;
  * the control (fp8 in the stage) fails the stage's number;
  * a stage number the limits file does not name stops the run;
  * the stage's work items reach `run.work` and `mfu`;
  * the stage's span is in the tracer's span set;
  * no file of the copy's pbcore/ differs from the harness's own.
"""

import filecmp
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from pbcore import spec

CELL, STAGE = "int8-text-mlp", "toy_mlp"

FILES = {
    "stages/toy_mlp.py": '''
        """A toy stage: a seeded two-layer MLP over the mean of a passage's
        word vectors, scoring each fused row of each query.

          port       float32 on the run's device (`Scorer`, built in set-up)
          reference  float64, every weight drawn again from the seed
          control    the reference with fp8 operands (Precision.encoder)
        """

        import math

        import numpy as np
        import torch

        from pbcore import data
        from reference.precision import fp8

        SPANS = ("toy_mlp",)
        WIDTH = 32


        def weights(config, seed, device):
            v, h = int(config["vocab_words"]), WIDTH
            g = data.generator(device, seed, "weights.toy_mlp")
            return {"emb": torch.randn((v, h), generator=g, device=device),
                    "w1": torch.randn((h, h), generator=g, device=device) / math.sqrt(h),
                    "w2": torch.randn((h, 1), generator=g, device=device) / math.sqrt(h)}


        def score(w, words, rows, dtype=torch.float32, round_to=None):
            r = lambda x: round_to(x) if round_to is not None else x
            live = torch.from_numpy(np.asarray(rows)).long()
            ids = torch.from_numpy(words[np.maximum(live.numpy(), 0)]).long()
            dev = w["emb"].device
            x = w["emb"].to(dtype)[ids.to(dev)].mean(dim=2)
            hid = torch.relu(r(x) @ r(w["w1"].to(dtype)))
            s = (r(hid) @ r(w["w2"].to(dtype)))[..., 0]
            return torch.where(live.to(dev) >= 0, s, 0.0)


        class Scorer:
            def __init__(self, config, seed, device, words):
                self.w, self.words = weights(config, seed, device), words

            def __call__(self, rows):
                return score(self.w, self.words, rows)


        def build(system, config, traffic, seed, device):
            system.stages["toy_mlp"] = Scorer(config, seed, device, system.words)


        def work(config, traffic):
            b, k, h = int(traffic["batch_size"]), int(traffic["top_k"]), WIDTH
            flops = b * k * (2.0 * h * h + 2.0 * h)
            return {"toy_mlp": [("toy mlp", flops, 4.0 * h * (h + 1), "fp32_flops_per_s")]}


        def _reference(world, rows, round_to=None):
            w = weights(world.config, world.seed, world.device)
            return score(w, world.corpus.words, rows, torch.float64, round_to)


        def _fused_rows(batch):
            """The port's fused rows (judged by fused_gap): the rows scored."""
            rows = batch.out["fused"][1]
            return rows.cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows)


        def judge(world, batch, out):
            ref = _reference(world, _fused_rows(batch))
            got = torch.as_tensor(out["toy_mlp"]).to(ref.device, torch.float64)
            return {"mlp_gap": float((got - ref).abs().max() / ref.abs().max().clamp_min(1.0))}


        def outputs(world, batch, prec):
            round_to = fp8 if prec.encoder == "fp8" else None
            return {"toy_mlp": _reference(world, _fused_rows(batch), round_to).float()}
    ''',
    "drivers/search_mlp.py": '''
        """Hybrid search, then the toy stage over the fused rows: one request is
        one batch of text queries through embed_queries_device ->
        search_rows(_qdev, fetch=True) -> the stage's scorer."""


        class Driver:
            def __init__(self, system, queries, tracer):
                self.system, self.queries, self.tracer = system, queries, tracer

            def issue(self, i):
                texts = self.queries.texts[i]
                with self.tracer.span("embed"):
                    qdev = self.system.embed(texts)
                with self.tracer.span("search"):
                    res = self.system.search(texts, qdev=qdev, fetch=True)
                with self.tracer.span("toy_mlp"):
                    scores = self.system.stages["toy_mlp"](res["fused"][1])
                out = {leg: res[leg] for leg in ("dense", "bm25", "fused")}
                out["qdev"], out["toy_mlp"] = qdev, scores
                return out

            def complete(self, pending):
                return pending
    ''',
    "metrics/toy_mlp_ms.py": '''
        """toy_mlp_ms: device milliseconds per request under the "toy_mlp" span."""

        from pbcore.readers import span_ms


        def read(run):
            return span_ms(run, "toy_mlp")
    ''',
}


def _traffic():
    t = json.loads((spec.ROOT / "traffic" / "text-b2048.json").read_text())
    t.update(driver="search_mlp", stages=[STAGE], why="the text hybrid, then a toy MLP stage")
    return t


def _limits():
    lim = json.loads((spec.ROOT / "limits" / "int8-text-b2048.json").read_text())
    return {**lim, "mlp_gap": 1e-4}


RUNNER = '''
import dataclasses, json, sys
sys.path[:0] = [{root!r}, {root!r} + "/portbench", {root!r} + "/portbench/tests", {repo!r}]
import tiny
from pbcore import cell, spec, trace
from work import counts

runs, spans = [], []
class Run(cell.Run):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        runs.append(self)
cell.Run = Run
tracer = trace.Tracer
def spy(enabled, spans_=trace.SPANS):
    spans.append(list(spans_))
    return tracer(enabled, spans_)
cell.trace.Tracer = spy

def altered(driver):
    scorer = driver.system.stages["toy_mlp"]
    driver.system.stages["toy_mlp"] = lambda rows: scorer(rows) + 0.5

res = {{}}
out = tiny.run({cell!r}, control=True)
res["sound"] = out.line
run = runs[-1]
res["work"] = {{k: [list(i) for i in v] for k, v in run.work.items()}}
mfu = spec.load_module(spec.ROOT / "metrics" / "mfu.py", "mfu")
fake = trace.TraceSummary(window_s=1.0, busy_s=1.0, ops=[], gaps=[])
with_stage = mfu.read(dataclasses.replace(run, trace=fake))
without = mfu.read(dataclasses.replace(run, trace=fake, work={{k: v for k, v in run.work.items()
                                                              if k != "toy_mlp"}}))
res["mfu_gain"] = with_stage - without
res["mfu_expected"] = counts.least_seconds(run.work["toy_mlp"]) * run.requests * 100.0
res["spans"] = spans[-1]
res["faulted"] = tiny.run({cell!r}, fault=altered).line["correct"]
limits = spec.ROOT / "limits" / ({cell!r} + ".json")
full = limits.read_text()
limits.write_text(json.dumps({{k: v for k, v in json.loads(full).items() if k != "mlp_gap"}}))
try:
    tiny.run({cell!r})
    res["unlimited"] = "ran"
except KeyError as e:
    res["unlimited"] = str(e)
finally:
    limits.write_text(full)
print(json.dumps(res))
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(spec.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": CELL, "config": "minilm-l12-int8-1m",
                               "traffic": "text-mlp", "chips": 1,
                               "why": "the int8 text hybrid, then a toy MLP over the fused rows"})
    bench["per_layer"].append({"name": "toy_mlp_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "Toy stage", "moves": "qps",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    pb = root / "portbench"
    (pb / "stages").mkdir(exist_ok=True)
    for rel, text in FILES.items():
        (pb / rel).write_text(textwrap.dedent(text).lstrip())
    (pb / "traffic" / "text-mlp.json").write_text(json.dumps(_traffic(), indent=1))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(_limits(), indent=1))
    code = RUNNER.format(root=str(root), repo=str(spec.CHECKOUT), cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    return root, json.loads(out.stdout.strip().splitlines()[-1])


def test_the_stage_is_judged(copy):
    _, res = copy
    line = res["sound"]
    assert line["correct"] is True, line["compare"]
    assert set(line["compare"]) == set(_limits())
    assert line["compare"]["mlp_gap"]["value"] <= 1e-4


def test_an_altered_stage_answer_is_not_correct(copy):
    assert copy[1]["faulted"] is False


def test_the_control_fails_the_stages_number(copy):
    ctl = copy[1]["sound"]["control"]
    assert ctl["mlp_gap"]["value"] > ctl["mlp_gap"]["limit"], ctl
    assert copy[1]["sound"]["control_correct"] is False


def test_a_number_without_a_limit_stops_the_run(copy):
    assert "mlp_gap" in copy[1]["unlimited"]


def test_the_stage_work_reaches_run_work_and_mfu(copy):
    _, res = copy
    (item,) = res["work"]["toy_mlp"]
    assert item[0] == "toy mlp" and item[1] > 0
    assert res["mfu_gain"] == pytest.approx(res["mfu_expected"])
    assert res["mfu_gain"] > 0


def test_the_stage_span_is_in_the_cells_set(copy):
    assert copy[1]["spans"][-1] == "toy_mlp"


def test_no_harness_core_file_changed(copy):
    root, _ = copy
    cmp = filecmp.dircmp(spec.ROOT / "pbcore", root / "portbench" / "pbcore",
                         ignore=["__pycache__"])
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    for rel in ("run.py", "control.py", "work/counts.py", "pbcore/__init__.py"):
        assert filecmp.cmp(spec.ROOT / rel, root / "portbench" / rel, shallow=False)


def test_the_core_names_no_stage():
    """No file of pbcore/ names a stage, the toy's model or its span."""
    names = {STAGE, "toy", "search_mlp"} | \
        {p.stem for p in (spec.ROOT / "stages").glob("*.py")}
    for f in (spec.ROOT / "pbcore").glob("*.py"):
        text = f.read_text().lower()
        assert not [n for n in names if n in text], f
