"""On a CUDA card: tiny cells through the program's kernels come out
correct, and a traced run reads every per-layer metric of its cell."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.conftest import make_root, tiny_config, tiny_mix


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["greedy", "leap", "nw"])
def test_tiny_cell_on_the_card(tmp_path, card, kind):
    mix = tiny_mix(kind, pool_pairs=8192, pairs_per_job=4096,
                   check_pairs_per_job=1024)
    root = make_root(tmp_path, [("tiny", tiny_config(), f"t_{kind}", mix)])
    r = harness.run_cell(root, f"tiny.t_{kind}", 2**31 + 3, 1.0, False,
                         device=card)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    t = harness.run_cell(root, f"tiny.t_{kind}", 2**31 + 4, 1.5, True,
                         device=card)
    assert t["correct"] is True
    assert {"device_idle_pct", "kernel_launches_per_job",
            f"{kind}_roofline_pct"} <= set(t["metrics"])
    assert 0 < t["metrics"][f"{kind}_roofline_pct"]["value"] <= 100
    assert 0 < t["device"]["busy_s"] <= t["device"]["window_s"]
