"""The port's exact NW on the CPU: the plain version (kernels/nw.py)
against asm_tpu.kernels.nw (XLA) and the scalar oracle nw_ref, and the
kernel wrappers nw_penalty_cuda / nw_align_cuda on CPU tensors (their
plain version) against asm_tpu's Pallas kernels in interpret mode; plus
pack_planes_t against asm_tpu.encoding's.

Tolerance everywhere: exact equality (integer DP, no rounding) of
penalties, traceback ops and match masks."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.encoding import pack_planes_t as jax_pack_planes_t
from asm_tpu.kernels import nw as jnw
from asm_tpu.kernels.nw_pallas import nw_align_pallas, nw_penalty_pallas
from asm_tpu.ops.cigar import batch_nw_cigars as jax_nw_cigars
from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu_torch.encoding import decode_string, pack_planes_t
from asm_tpu_torch.kernels import nw, nw_cuda, shapes
from asm_tpu_torch.ops.cigar import batch_nw_cigars

torch.set_num_threads(1)

# the edge pairs of tests/test_nw_band.py: one base, 128 bases, empty
EDGE_READS = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC", ""]
EDGE_REFS = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20, ""]

CORPORA = {
    "err0.05": dict(num_reads=64, length=100, error_rate=0.05, seed=1),
    "err0.2": dict(num_reads=64, length=100, error_rate=0.2, seed=2),
    "err0.4-mr0.5": dict(num_reads=64, length=100, error_rate=0.4,
                         mismatch_rate=0.5, seed=3),
    "length_range": dict(num_reads=64, length=100, error_rate=0.12,
                         mismatch_rate=0.8, seed=95, length_range=(40, 120)),
}
XOE = [(1, 1, 1), (2, 3, 1), (1, 4, 2)]


def _corpus(label):
    if label == "edges":
        return encode_batch(EDGE_READS, EDGE_REFS, 128)
    return generate_dataset_arrays(**CORPORA[label])


def _t(corpus):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in corpus]


@pytest.mark.parametrize("label", list(CORPORA) + ["edges"])
@pytest.mark.parametrize("xoe", XOE, ids=lambda v: "x%do%de%d" % v)
def test_plain_matches_xla(label, xoe):
    c = _corpus(label)
    a = [jnp.asarray(v) for v in c]
    np.testing.assert_array_equal(nw.nw_penalty(*_t(c), *xoe).numpy(),
                                  np.asarray(jnw.nw_penalty(*a, *xoe)))
    want = jnw.nw_align(*a, *xoe, match_mask_threshold=3)
    got = nw.nw_align(*_t(c), *xoe, match_mask_threshold=3)
    for g, w, key in zip(got, want, ("pen", "ops", "mask")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
    pen, ops = nw.nw_align(*_t(c), *xoe)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(want[1]))


def test_plain_matches_scalar_oracle():
    c = generate_dataset_arrays(12, 60, 0.15, 0.8, seed=7)
    rc, rl, fc, fl = c
    pen, ops = nw.nw_align(*_t(c), 2, 3, 1)
    for b in range(len(rl)):
        want, _ = nw_ref(decode_string(rc[b], int(rl[b])),
                         decode_string(fc[b], int(fl[b])), 2, 3, 1,
                         traceback=False)
        assert int(pen[b]) == want, b
    assert batch_nw_cigars(ops.numpy()) == jax_nw_cigars(
        np.asarray(jnw.nw_align(*map(jnp.asarray, c), 2, 3, 1)[1]))


@pytest.mark.parametrize("label", ["err0.05", "err0.4-mr0.5",
                                   "length_range", "edges"])
def test_wrappers_on_cpu_match_pallas_interpret(label):
    c = _corpus(label)
    a = [jnp.asarray(v) for v in c]
    t = _t(c)
    for xoe in [(1, 1, 1), (1, 4, 2)]:
        np.testing.assert_array_equal(
            nw_cuda.nw_penalty_cuda(*t, *xoe).numpy(),
            np.asarray(nw_penalty_pallas(*a, *xoe, interpret=True)))
        want = nw_align_pallas(*a, *xoe, match_mask_threshold=3,
                               interpret=True)
        got = nw_cuda.nw_align_cuda(*t, *xoe, match_mask_threshold=3)
        for g, w, key in zip(got, want, ("pen", "ops", "mask")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=key)
    assert nw_cuda.LAUNCHES == {"nw": 0, "nw_trace": 0}


def test_wrappers_check_arguments():
    rc, rl, fc, fl = _t(generate_dataset_arrays(8, 50, 0.1, seed=1))
    with pytest.raises(TypeError):
        nw_cuda.nw_penalty_cuda(rc.to(torch.int32), rl, fc, fl)
    with pytest.raises(ValueError):
        nw_cuda.nw_penalty_cuda(rc, rl[:4], fc, fl)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_cuda(rc.T, rl, fc, fl)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=-1)
    pen, ops = nw_cuda.nw_align_cuda(rc[:0], rl[:0], fc[:0], fl[:0])
    assert pen.shape == (0,) and ops.shape == (0, 256)


@pytest.mark.parametrize("L", [32, 128, 256])
def test_pack_planes_t_matches_jax(L):
    rc, _, fc, _ = generate_dataset_arrays(37, L - 10, 0.1, seed=L,
                                           max_len=L)
    for codes in (rc, fc):
        want = jax_pack_planes_t(jnp.asarray(codes))
        got = pack_planes_t(torch.from_numpy(codes))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).view(np.int32))


def _nw_cu_instances():
    """csrc/nw.cu's table of instantiations: {(W, trace): (G, route)}."""
    with open(nw_cuda.SOURCE) as f:
        src = f.read()
    routes = dict(PTR_NONE=nw_cuda.ROUTE_NONE, PTR_GLOBAL=nw_cuda.ROUTE_GLOBAL,
                  PTR_SHARED=nw_cuda.ROUTE_SHARED)
    return {(int(w), t == "true"): (int(g), routes[r]) for w, t, g, r in
            re.findall(r"struct Inst<(\d+), (true|false)> \{ static constexpr "
                       r"int G = (\d+), ROUTE = (\w+); \}", src)}


class _FakeLib:
    """asm_nw_instance over csrc/nw.cu's table, as ctypes calls it."""

    def __init__(self, table):
        self.table = table

    def asm_nw_instance(self, W, trace, G, route):
        if (W, bool(trace)) not in self.table:
            return 1
        G._obj.value, route._obj.value = self.table[W, bool(trace)]
        return 0


@pytest.mark.parametrize("trace", [False, True], ids=["nw", "nw_trace"])
@pytest.mark.parametrize("L", [128, 256, 512])
def test_nw_cu_instance_table(L, trace):
    """csrc/nw.cu builds one instantiation per kernel and max_len: R = L/G
    rows per thread a multiple of 4 and at most 32, the route ids the
    ones nw_cuda names (no pointers for the penalty; the trace kernel's
    in shared memory at L = 128, in the global scratch at L = 256 and
    512), and `function_name` the instantiation's mangled name."""
    table = _nw_cu_instances()
    assert sorted(table) == [(4, False), (4, True), (8, False), (8, True),
                             (16, False), (16, True)]
    G, route = table[L // 32, trace]
    assert G in (8, 16, 32) and (L // G) % 4 == 0 and L // G <= 32
    assert route == (nw_cuda.ROUTE_NONE if not trace else
                     {128: nw_cuda.ROUTE_SHARED, 256: nw_cuda.ROUTE_GLOBAL,
                      512: nw_cuda.ROUTE_GLOBAL}[L])
    with open(nw_cuda.SOURCE) as f:
        src = f.read()
    assert re.search(r"enum \{ PTR_NONE = 0, PTR_GLOBAL = 1, PTR_SHARED = 2 \}",
                     src)
    # the shape plan's copy of the table (kernels/shapes.py)
    assert shapes.nw_instance(trace, L) == (G, route)
    assert shapes.NW_TUNED == table
    nw_cuda.instance.cache_clear()
    try:
        nw_cuda._libs["nw"] = _FakeLib(table)
        assert nw_cuda.instance(trace, L) == (G, route)
        assert nw_cuda.function_name(trace, L) == (
            f"nw_kernelILi{L // 32}ELi{G}ELi{route}E")
        # past max_len 512 the long path: G32 and the global route (the
        # trace), a kernel of its own each; past its shared memory a
        # refusal
        assert shapes.nw_instance(trace, 544) == (
            32, nw_cuda.ROUTE_GLOBAL if trace else nw_cuda.ROUTE_NONE)
        assert nw_cuda.function_name(trace, 544) == (
            "nw_long_kernelILi17ELb1E" if trace
            else "nw_long_full_kernelILi17E")
        with pytest.raises(NotImplementedError, match="shared memory"):
            nw_cuda.plan(32 * 1024)
    finally:
        nw_cuda._libs.pop("nw", None)
        nw_cuda.instance.cache_clear()


def test_trace_scratch_pieces_follow_the_route(monkeypatch):
    """Only the global route cuts a launch into scratch-sized pieces:
    L * L / 2 bytes a pair, TRACE_SCRATCH_BYTES a piece."""
    calls = []
    monkeypatch.setattr(nw_cuda, "LAUNCHES", {"nw": 0, "nw_trace": 0})
    monkeypatch.setattr(nw_cuda, "_launch", lambda *a: calls.append(
        (a[0].shape[0], a[11] is None or a[11].shape)))
    monkeypatch.setattr(nw_cuda, "instance", lambda trace, L: (
        16, nw_cuda.ROUTE_SHARED if L == 128 else nw_cuda.ROUTE_GLOBAL))
    monkeypatch.setattr(nw_cuda, "_checked", lambda rc, rl, fc, fl: (
        torch.device("cuda", 0), rc.shape[0], rc.shape[1]))
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: torch.zeros(
        *a, **{k: v for k, v in kw.items() if k != "device"}))
    for L in (128, 256):
        rc, rl, fc, fl = _t(generate_dataset_arrays(300, L - 30, 0.1, seed=2,
                                                    max_len=L))
        monkeypatch.setattr(nw_cuda, "TRACE_SCRATCH_BYTES", L * L // 2 * 64)
        calls.clear()
        nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=3)
        if L == 128:
            assert calls == [(300, True)]
        else:
            assert calls == [(n, (64, L * L // 2))
                             for n in (64, 64, 64, 64, 44)]
