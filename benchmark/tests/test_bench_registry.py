"""The harness finds a cell, a configuration, a traffic mix and a
per-layer metric by name from files dropped into a copy, with no edit to
the harness; the added cell then runs end to end on the CPU."""

import json
import os

import pytest

from bench_micro import context, micro_base, small_tower

from benchmark import harness
from benchmark import run as R

METRIC = '''"""Steps traced (a test metric)."""


def read(rec):
    return float(rec["calls"])
'''


def _add_files(base: str) -> None:
    with open(harness.path("configs", "w_geo", base=base)) as f:
        cfg = json.load(f)
    cfg["name"] = "w_geo_copy"
    with open(harness.path("configs", "w_geo_copy", base=base), "w") as f:
        json.dump(cfg, f)
    with open(harness.path("traffic", "train", base=base)) as f:
        mix = json.load(f)
    mix["episodes"]["episodes"] = 1
    with open(harness.path("traffic", "train_one", base=base), "w") as f:
        json.dump(mix, f)
    with open(harness.path("workloads", "w_geo.train", base=base)) as f:
        cell = json.load(f)
    cell.update(config="w_geo_copy", traffic="train_one", traced_steps=1)
    with open(harness.path("workloads", "w_geo_copy.train", base=base), "w") as f:
        json.dump(cell, f)
    with open(harness.path("metrics", "steps_traced.train", ".py", base), "w") as f:
        f.write(METRIC)
    spec_path = os.path.join(os.path.dirname(base), "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    step = [e for e in spec["end_to_end"] if e["name"] == "train_step_ms"]
    if step:
        step[0]["workloads"].append("w_geo_copy.train")
    else:
        spec["end_to_end"].append({"name": "train_step_ms", "unit": "ms",
                                   "better": "lower", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": ["w_geo_copy.train"]})
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "host dispatch",
                              "moves": "train_step_ms",
                              "workloads": ["w_geo_copy.train"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)


def test_added_files_are_found_and_run(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    base = micro_base(str(tmp_path / "copy"))
    before = {k: harness.names(k, base=base)
              for k in ("workloads", "configs", "traffic")}
    _add_files(base)
    assert harness.names("workloads", base=base) == sorted(
        before["workloads"] + ["w_geo_copy.train"])
    assert "w_geo_copy" in harness.names("configs", base=base)
    assert "train_one" in harness.names("traffic", base=base)
    assert set(harness.metrics_for("w_geo_copy.train", base)) == {
        "steps_traced.train"}
    assert "train_step_ms" in harness.end_to_end_for("w_geo_copy.train", base)
    fields, checks = R.run_cell(context(base, "w_geo_copy.train", trace=True),
                                base)
    assert fields["metrics"]["steps_traced.train"]["value"] == 1.0
    assert fields["attempted"] > 0
    assert {c[0] for c in checks} == {"attn", "change", "render"}
    assert fields["correct"]


def test_every_named_file_exists():
    spec = harness.spec()
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
    for w in spec["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        harness.load_json("traffic", w["traffic"])
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_metric_without_workloads_follows_what_it_moves(tmp_path, monkeypatch):
    """A per-layer entry without `workloads` is reported in every cell that
    reports the end-to-end metric it moves, the cells added later too."""
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    base = micro_base(str(tmp_path / "copy"))
    with open(harness.path("metrics", "steps_traced", ".py", base), "w") as f:
        f.write(METRIC)
    spec_path = os.path.join(os.path.dirname(base), "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "host dispatch",
                              "moves": "act_ms_p50"})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    for cell in ("w_geo.train", "w_geo_sem_dyna.train", "w_geo.act"):
        assert ("steps_traced" in harness.metrics_for(cell, base)) == (
            cell == "w_geo.act")


@pytest.mark.parametrize("trace", [False, True])
def test_gnfactor_cell_runs_and_reports_its_metrics(trace, tmp_path,
                                                    monkeypatch):
    """The GNFactor cell as `BENCHMARK.json` lists it runs on the CPU:
    untraced it reports `train_step_ms` and `setup_s`; traced, of its
    per-layer metrics those that a run without a device has to read (the
    host's feed wait and the step's FLOPs over the window's step time)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    small_tower(monkeypatch)
    base = micro_base(str(tmp_path / "copy"))
    cell = "gnfactor_bc.train"
    assert harness.end_to_end_for(cell, base) == ["setup_s", "train_step_ms"]
    named = set(harness.metrics_for(cell, base))   # each has its reader
    assert named == {e["name"] for e in harness.spec(base)["per_layer"]
                     if cell in e.get("workloads", ())}
    fields, checks = R.run_cell(context(base, cell, trace=trace), base)
    assert fields["correct"], checks
    assert {c[0] for c in checks} == {"attn", "attn_bwd", "lamb_step",
                                      "change", "nerf_rays", "gt_embed"}
    if trace:
        assert {"feed_wait_ms.train", "mfu.train"} <= set(fields["metrics"])
        assert set(fields["metrics"]) <= named
    else:
        assert set(fields["metrics"]) == {"train_step_ms", "setup_s"}
        assert fields["metrics"]["train_step_ms"]["value"] > 0
