"""Shared fixtures: a checkout root in a temporary folder that holds a
BENCHMARK.json of tiny cells, their configuration and mix files, and
nothing else, so a cell is made of files alone; and the card fixture of
the `cuda` tests."""

from __future__ import annotations

import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_json(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def tiny_config(**over) -> dict:
    with open(os.path.join(REPO, "perfbench", "configs", "sim100.json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def tiny_mix(kind: str, **over) -> dict:
    mix = dict(job=kind, error_rates=[0.05, 0.20], shares=[0.5, 0.5],
               order="interleaved", pool_pairs=384, pairs_per_job=128,
               check_jobs=2, check_pairs_per_job=128)
    mix.update(over)
    return mix


def make_root(root, cells) -> str:
    """A checkout root under `root` with the real BENCHMARK.json's metrics
    and one cell per (config name, config, mix name, mix) of `cells`."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"], bench["workloads"] = [], []
    for cname, cfg, mname, mix in cells:
        if cname not in [c["name"] for c in bench["configs"]]:
            path = f"perfbench/configs/{cname}.json"
            write_json(os.path.join(root, path), cfg)
            bench["configs"].append(dict(name=cname, source="test",
                                         file=path, reduced=[], why="test"))
        write_json(os.path.join(root, "perfbench", "mixes", mname + ".json"),
                   mix)
        bench["workloads"].append(dict(name=f"{cname}.{mname}", config=cname,
                                       traffic=mname, chips=1, why="test"))
    names = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = names
    write_json(os.path.join(root, "BENCHMARK.json"), bench)
    return str(root)


@pytest.fixture
def tiny_root(tmp_path):
    cfg = tiny_config()
    return make_root(tmp_path, [("tiny", cfg, f"t_{k}", tiny_mix(k))
                                for k in ("greedy", "leap", "nw")])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
