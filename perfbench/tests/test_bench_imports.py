"""What a run loads: no module whose top-level name is that of JAX, Flax
or the JAX package (compared whole: the port's name begins with the JAX
package's), and a reference that loads nothing of the port.  And the
harness's refusals: no result without CUDA, or without the port."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "lgu_slam_tpu", "lgu_native"}
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

RUN_CELL = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from conftest import tiny
from perfbench.harness import core
core.run_cell({cell!r}, {seed}, 0.2, {traced}, device="cpu",
              scale=tiny({cell!r}, fp32=True))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_are_compared():
    from perfbench.harness.core import forbidden_modules
    sys.modules.setdefault("lgu_slam_tpu_torch_like", sys)  # a prefix only
    try:
        assert "lgu_slam_tpu" not in forbidden_modules()
    finally:
        del sys.modules["lgu_slam_tpu_torch_like"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_loads_no_jax(cell, traced):
    names = loaded(RUN_CELL.format(root=str(ROOT),
                                   tests=str(ROOT / "perfbench/tests"),
                                   cell=cell, seed=SEED, traced=traced))
    assert "lgu_slam_tpu_torch" in names and "perfbench" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = sorted(str(p.relative_to(ROOT).with_suffix("")).replace("/", ".")
                  for p in (ROOT / "perfbench/reference").rglob("*.py"))
    names = loaded(f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
                   + "".join(f"import {m}\n" for m in mods)
                   + "print(json.dumps(sorted({m.split('.')[0] "
                     "for m in sys.modules})))")
    assert "lgu_slam_tpu_torch" not in names
    assert not names & FORBIDDEN


def run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "eth3d_rgbd.track", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_cuda():
    out = run_py(ROOT)
    assert out.returncode != 0 and "{" not in out.stdout


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
