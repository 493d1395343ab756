"""The port's LEAP slice end to end on the CPU: the LEAP headline flow
(leap_headline.run, every kernel wrapper on its plain version) on native
corpus pairs, and the filter CLI (apps.leap_filter) on a pair file,
against the JAX package on the same inputs: asm_tpu's XLA leap_align,
its history + backtrack, and its own filter CLI.

Tolerance: exact equality of the checksums, passed counts, per-pair
penalties, per-chunk energy bounds, CIGAR digests and pass counts."""

import contextlib
import hashlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.apps import leap_filter as jax_filter
from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch as jax_bt
from asm_tpu.native import generate_dataset_native
from asm_tpu_torch import leap_headline
from asm_tpu_torch.apps import leap_filter
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.encoding import decode_string
from asm_tpu_torch.kernels import leap_cuda
from asm_tpu_torch.kernels.leap import leap_align
from asm_tpu_torch.utils.bounds import leap_levels
from asm_tpu_torch.utils.timing import time_reps

torch.set_num_threads(1)


@pytest.mark.parametrize("err,n,chunk", [(0.05, 3000, 1024),
                                         (0.15, 2000, 2000)])
def test_headline_flow_matches_jax(err, n, chunk):
    res = leap_headline.run(n_pairs=n, chunk=chunk, err=err, tile=256,
                            device="cpu", reps=0, digest=True)
    corpus = generate_dataset_native(n, 100, err, mismatch_rate=0.96,
                                     seed=42, max_len=128)
    for a, b in zip(res["corpus"], corpus):
        np.testing.assert_array_equal(a, b)
    args = list(map(jnp.asarray, corpus))
    cfg = JaxConfig(k=3)
    hist = jax_leap(*args, cfg, want_history=True)
    pen, ps = np.asarray(hist["penalty"]), np.asarray(hist["passed"])
    gated = jax_leap(*args, JaxConfig(k=3, leap_af_threshold=3),
                     semantics="simd_ed_lev", use_shd_gate=True)

    assert res["leap"]["checksum"] == int(pen.sum())
    assert res["leap"]["passed"] == int(ps.sum())
    got_pen = torch.cat([o["penalty"] for o in res["leap"]["outs"]]).numpy()
    np.testing.assert_array_equal(got_pen, pen[res["perm"]])
    assert (np.diff(got_pen) >= 0).all()  # the measured-energy order
    assert res["leap_gated"]["checksum"] == int(
        np.asarray(gated["penalty"]).sum() + np.asarray(gated["passed"]).sum())
    assert res["leap_cigar"]["checksum"] == int(pen.sum())

    # per-chunk bounds: each chunk's largest passed energy, rounded to 16
    sorted_e = np.where(ps, pen, 0)[res["perm"]]
    maxe = [int(sorted_e[i:i + chunk].max()) for i in range(0, n, chunk)]
    assert res["chunk_max_energy"] == maxe
    assert res["leap_cigar"]["energy_bounds"] == [
        max(16, -(-e // 16) * 16) for e in maxe]
    cigars = [c[1] for c in jax_bt(hist, cfg) if c is not None]
    assert res["leap_cigar"]["digest"] == (
        hashlib.sha256("\n".join(cigars).encode()).hexdigest(), len(cigars))
    assert leap_cuda.LAUNCHES == 0  # the CPU route launches nothing


def test_affine_cigar_flow_bounds():
    res = leap_headline.run(n_pairs=1500, chunk=512, err=0.1, tile=128,
                            device="cpu", reps=0, which=("leap_cigar",),
                            cigar_cfg="affine")
    corpus = generate_dataset_native(1500, 100, 0.1, mismatch_rate=0.96,
                                     seed=42, max_len=128)
    out = jax_leap(*map(jnp.asarray, corpus), JaxConfig(x=2, o=3, e=1, k=3))
    pen = np.where(np.asarray(out["passed"]), np.asarray(out["penalty"]), 0)
    lc = res["leap_cigar"]
    assert lc["checksum"] == int(np.asarray(out["penalty"]).sum())
    chunks = [pen[res["perm"][i:i + 512]] for i in range(0, 1500, 512)]
    assert lc["chunk_max_energy"] == [int(c.max()) for c in chunks]
    assert lc["energy_bounds"] == [max(16, -(-int(c.max()) // 16) * 16)
                                   for c in chunks]


@pytest.mark.parametrize("sem,gate,af,err", [
    ("lv_bag", False, 200, 0.1), ("lv_bag", False, 4, 0.03),
    ("simd_ed_lev", True, 3, 0.1), ("simd_ed_lev", False, 3, 0.03)])
def test_leap_levels_equal_the_plain_stop_levels(sem, gate, af, err):
    """The bound's level count, read from the outputs, equals the levels
    the plain leap_align ran, pair by pair (unequal lengths, gated pairs
    and pairs that never converge included)."""
    corpus = generate_dataset_arrays(1500, 100, err, 0.9, seed=5,
                                     length_range=(60, 120))
    out = leap_align(*map(torch.from_numpy, corpus),
                     AlignConfig(k=3, leap_af_threshold=af), semantics=sem,
                     use_shd_gate=gate, want_levels=True)
    got = leap_levels(out["passed"].numpy(), out["penalty"].numpy(),
                      out["lane_shift"].numpy(), af, sem)
    want = out["levels"].numpy()
    np.testing.assert_array_equal(got, want)
    assert (want < af).any()
    assert (want == af).any() == (af < 200)  # some never converge
    if gate:
        assert ((want == 0) & ~out["passed"].numpy()).any()


def test_time_reps_on_the_cpu_runs_the_warm_up_only():
    calls = []
    rep_s, best, outs = time_reps([lambda: calls.append(1) or 7], 3, "cpu")
    assert (rep_s, best, outs, calls) == ([], {}, [7], [1])


def test_baseline_rate_nearest():
    assert leap_headline.baseline_rate(0.05) == 1e6 / 1.55
    assert leap_headline.baseline_rate(0.19) == 1e6 / 4.47


def _pair_file(path, n=600):
    """Pairs of read lengths 90-250, refs cut / padded by the CLI."""
    with open(path, "w") as f:
        for length, err, seed in ((90, 0.02, 7), (250, 0.01, 8)):
            rc, rl, fc, fl = generate_dataset_native(
                n // 2, length, err, mismatch_rate=0.9, seed=seed,
                max_len=256)
            for i in range(n // 2):
                f.write(f"{decode_string(rc[i], rl[i])}\n"
                        f"{decode_string(fc[i], fl[i])}\n")


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    lines = dict(ln.split(": ") for ln in out.getvalue().splitlines())
    return int(lines["passNum"]), int(lines["totalNum"])


@pytest.mark.parametrize("argv", [["3"], ["3", "0", "0"], ["2", "1", "0"],
                                  ["4", "0", "1"]])
def test_filter_cli_matches_jax(tmp_path, argv):
    path = str(tmp_path / "pairs.seq")
    _pair_file(path)
    want = _run_cli(jax_filter.main, argv + ["--file", path])
    got = _run_cli(leap_filter.main, argv + ["--file", path,
                                             "--device", "cpu"])
    assert got == want and want[1] == 600 and 0 < want[0] < 600
