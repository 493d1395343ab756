"""A run with its timed path broken underneath comes out not correct: an
answer altered where the program produces it, half of each job left
out, and the control (the reference with a stated guarantee broken) put
in the program's place. Each drives the rest of a run on the CPU."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import make_root, tiny_config, tiny_mix

SEED = 2**31 + 777
ENTRIES = {
    "greedy": ("asm_tpu_torch.kernels.greedy_cuda", "greedy_align_cuda",
               "cost"),
    "leap": ("asm_tpu_torch.kernels.leap_cuda", "leap_align_cuda",
             "penalty"),
    "nw": ("asm_tpu_torch.kernels.nw_band", "nw_penalty_partitioned", None),
}


def broken(kind, monkeypatch, fault):
    """Patch the program's entry of `kind` so that it commits `fault`."""
    import importlib

    mod_name, fn_name, key = ENTRIES[kind]
    mod = importlib.import_module(mod_name)
    real = getattr(mod, fn_name)

    def entry(read, read_len, ref, ref_len, *a, **kw):
        n = len(read_len)
        if fault == "half":  # the second half of the batch left out
            h = n // 2
            out = real(read[:h], read_len[:h], ref[:h], ref_len[:h], *a,
                       **kw)
            pad = (lambda v: torch.cat([torch.as_tensor(v),
                                        torch.zeros_like(
                                            torch.as_tensor(v))[:n - h]]))
            return ({k: pad(v) for k, v in out.items()}
                    if isinstance(out, dict) else pad(out).numpy())
        out = real(read, read_len, ref, ref_len, *a, **kw)
        if isinstance(out, dict):
            out[key] = out[key].clone()
            out[key][n // 3] += 1
        else:
            out = out.copy()
            out[n // 3] += 1
        return out

    monkeypatch.setattr(mod, fn_name, entry)


@pytest.mark.parametrize("fault", ["answer", "half"])
@pytest.mark.parametrize("kind", ["greedy", "leap", "nw"])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, kind, fault):
    broken(kind, monkeypatch, fault)
    r = harness.run_cell(tiny_root, f"tiny.t_{kind}", SEED, 0.2, False,
                         device="cpu")
    assert r["correct"] is False
    assert r["failed"] >= 1
    assert sum(c["value"] for c in r["checks"].values()) > 0


@pytest.mark.parametrize("kind,cfg,mix", [
    ("greedy", {}, dict(error_rates=[0.20], shares=[1.0], pool_pairs=2048,
                        pairs_per_job=1024, check_pairs_per_job=1024)),
    ("leap", {}, dict(error_rates=[0.20], shares=[1.0], pool_pairs=2048,
                      pairs_per_job=1024, check_pairs_per_job=1024)),
    ("nw", dict(read_length=200, max_len=256, max_steps=256,
                mismatch_rate=0.5), dict(error_rates=[0.20], shares=[1.0])),
])
def test_the_control_is_not_correct(tmp_path, kind, cfg, mix):
    root = make_root(tmp_path, [("ctl", tiny_config(**cfg), f"c_{kind}",
                                 tiny_mix(kind, **mix))])
    from perfbench.control import control_run

    r = control_run(root, f"ctl.c_{kind}", SEED, device="cpu")
    assert r["correct"] is False
    assert r["attempted"] == 2
