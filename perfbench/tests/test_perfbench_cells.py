"""A cell is made of files: a configuration and a mix placed beside a
BENCHMARK.json become a run, on the CPU through the program's plain
routes, with the result line the benchmark prints."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import REPO, make_root, tiny_config, tiny_mix

SEED = 2**31 + 12345  # wider than 32 signed bits
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("kind", ["greedy", "leap", "nw"])
def test_a_cell_is_its_files(tmp_path, kind):
    root = make_root(tmp_path, [("newcfg", tiny_config(), "new_mix",
                                 tiny_mix(kind))])
    r = harness.run_cell(root, "newcfg.new_mix", SEED, 0.2, False,
                         device="cpu")
    assert list(r) == LINE_KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"pairs_per_s", "job_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"] == dict(platform="cpu", kind="cpu", count=1,
                               memory_peak_bytes=0)
    outputs = harness._module("jobs", kind).OUTPUTS
    assert list(r["checks"]) == [f"{k}_differ" for k in outputs]
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())


def test_traced_line(tiny_root):
    r = harness.run_cell(tiny_root, "tiny.t_greedy", SEED, 0.3, True,
                         device="cpu")
    assert list(r) == LINE_KEYS + ["breakdown", "checks"]
    assert r["correct"] is True
    # no device on the CPU: no device metric is read
    assert r["metrics"] == {}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    json.dumps(r)


def test_cells_of_the_benchmark_load():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        assert cell.kind in ("greedy", "leap", "nw")
        assert cell.mix["pool_pairs"] % cell.mix["pairs_per_job"] == 0
        names = {m["name"] for m in cell.per_layer}
        assert {"device_idle_pct", "kernel_launches_per_job"} <= names
        assert any(n.endswith("_roofline_pct") for n in names)
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(
                harness.PKG_DIR, "metrics", m["name"] + ".py"))


def test_cli_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "sim100.greedy_mix4", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 3
    assert res.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import types

    assert "asm_tpu_torch" in sys.modules
    monkeypatch.setitem(sys.modules, "asm_tpu_torchx", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "asm_tpu.kernels", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["asm_tpu", "jaxlib"]


def test_p95_and_reservoir():
    import numpy as np

    assert harness.p95(range(1, 101)) == 95
    assert harness.p95([3.0]) == 3.0
    res = harness.Reservoir(3, np.random.default_rng(1))
    for j in range(1000):
        res.offer(j)
    assert len(res.items) == 3 and len(set(res.items)) == 3
    again = harness.Reservoir(3, np.random.default_rng(1))
    for j in range(1000):
        again.offer(j)
    assert again.items == res.items


@pytest.mark.parametrize("size,jobs", [(2, 5), (4, 40)])
def test_reservoir_is_uniform(size, jobs):
    """Every job of the window is in the sample with chance size / jobs."""
    import numpy as np

    runs = 20000
    hits = np.zeros(jobs)
    for seed in range(runs):
        res = harness.Reservoir(size, np.random.default_rng(seed))
        for j in range(jobs):
            res.offer(j)
        assert len(set(res.items)) == size
        hits[res.items] += 1
    share = hits / runs
    assert np.abs(share - size / jobs).max() < 0.02

