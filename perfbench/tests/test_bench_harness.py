"""The harness finds every cell's files by name, BENCHMARK.json keeps to the
benchmark's format, and a cell added as new files runs without an edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT, SEED, tiny
from perfbench.harness import core

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = core.load_cell(cell)
    spec = {w["name"]: w for w in SPEC["workloads"]}[cell]
    conf = {x["name"]: x for x in SPEC["configs"]}[spec["config"]]
    assert json.loads((ROOT / conf["file"]).read_text()) == c.config
    assert set(conf["reduced"]) == set(c.config["reduced"])
    assert c.traffic["driver"] in ("track", "global_ba", "train")
    assert core.load_driver(c) is not None
    assert c.limits["limits"]
    # every cell reports setup_s, another end-to-end and a per-layer metric
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(core.load_reader(m["name"]))


def test_new_cell_from_files_runs(tmp_path):
    """A cell that later work adds as data files only (a traffic mix, a
    workload file and BENCHMARK.json entries) runs with no code edited."""
    root = tmp_path / "checkout"
    (root / "perfbench").mkdir(parents=True)
    for part in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(ROOT / "perfbench" / part, root / "perfbench" / part)
    traffic = json.loads((ROOT / "perfbench/traffic/loop96.json").read_text())
    traffic["loop"]["frames"] = 48
    (root / "perfbench/traffic/loop48.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "perfbench/workloads/eth3d_rgbd.track.json",
                root / "perfbench/workloads/eth3d_rgbd.loop48.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "eth3d_rgbd.loop48",
                              "config": "eth3d_rgbd", "traffic": "loop48",
                              "chips": 1, "why": "a faster loop"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "eth3d_rgbd.track" in m.get("workloads", []):
            m["workloads"].append("eth3d_rgbd.loop48")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = core.run_cell("eth3d_rgbd.loop48", SEED, 0.5, False, device="cpu",
                      scale=tiny("eth3d_rgbd.track", fp32=True), root=root)
    assert r["correct"]
    assert set(r["metrics"]) == {"track_ms", "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    """The keys the result line carries, untraced and traced."""
    r = core.run_cell(cell, SEED, 0.2, True, device="cpu",
                      scale=tiny(cell, fp32=True))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-2:] == ["checks", "_notes"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    cell_ = core.load_cell(cell)
    assert set(r["checks"]) == set(cell_.limits["limits"])
    # on the CPU the device metrics have nothing to read and stay out
    names = {m["name"] for m in cell_.per_layer}
    assert set(r["metrics"]) <= names
    assert not any(k.startswith(("idle.", "k1_", "k2_")) for k in r["metrics"])
