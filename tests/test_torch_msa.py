"""The port's profile-profile alignment (`asm_tpu_torch.kernels.msa`) on
the CPU against asm_tpu's (`asm_tpu.kernels.msa`, XLA) on the same seeded
alignments, and against the scalar prototype mirror `msa_ref`.

Tolerance: `profiles_from_alignments` arrays bit-equal; `profile_align`
traceback ops exactly equal (ties are decided by float equality, so this
holds the port to XLA's float association, fused multiply-adds included);
scores within 1e-6 absolute of asm_tpu's (in practice bit-equal) and
within 1e-4 of the float64 prototype, the bound tests/test_msa.py uses."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asm_tpu.kernels import msa as jmsa
from asm_tpu.reference_impl.msa_ref import create_pssm as jax_create_pssm
from asm_tpu.reference_impl.msa_ref import profile_align_ref
from asm_tpu_torch.kernels import msa

torch.set_num_threads(1)

SCORE_TOL = 1e-6


def _random_alignment(rng, rows, length, alphabet="ACGT-"):
    return ["".join(rng.choice(list(alphabet), size=length))
            for _ in range(rows)]


def _mutated_alignment(rng, rows, length, rate=0.10):
    """Rows that are mutated copies of one random base: `rate` of their
    columns substituted or gapped."""
    base = rng.choice(list("ACGT"), size=length)
    out = []
    for _ in range(rows):
        r = base.copy()
        hit = rng.random(length) < rate
        r[hit] = rng.choice(list("ACGT-"), size=int(hit.sum()))
        out.append("".join(r))
    return out


def _both(als1, als2, max_len):
    """Profiles through both packages (bit-equal), then profile_align
    through both; returns (jax score, jax ops, port score, port ops)."""
    p1, n1 = jmsa.profiles_from_alignments(als1, max_len)
    p2, n2 = jmsa.profiles_from_alignments(als2, max_len)
    q1, m1 = msa.profiles_from_alignments(als1, max_len)
    q2, m2 = msa.profiles_from_alignments(als2, max_len)
    for a, b in ((p1, q1), (p2, q2)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert np.array_equal(n1, m1) and np.array_equal(n2, m2)
    j = jmsa.profile_align(*map(jnp.asarray, (p1, n1, p2, n2)))
    t = msa.profile_align(*map(torch.from_numpy, (q1, m1, q2, m2)))
    assert t["score"].dtype == torch.float32 and t["ops"].dtype == torch.int8
    return (np.asarray(j["score"]), np.asarray(j["ops"]),
            t["score"].numpy(), t["ops"].numpy())


def _assert_equal(als1, als2, max_len):
    js, jo, ts, to = _both(als1, als2, max_len)
    assert to.shape == jo.shape == (len(als1), 2 * max_len)
    bad = np.nonzero((jo != to).any(axis=1))[0]
    assert bad.size == 0, f"ops differ on pairs {bad[:10].tolist()}"
    assert np.abs(js - ts).max(initial=0.0) <= SCORE_TOL
    return ts, to


def test_pssm_matches_reference(rng):
    for rows, length in ((1, 1), (2, 7), (3, 40), (4, 120)):
        al = _random_alignment(rng, rows, length)
        want = jax_create_pssm(al)
        got = msa.create_pssm(al)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want)


def test_pssm_rejects_unknown_symbol():
    with pytest.raises(KeyError):
        msa.create_pssm(["ACGN"])


@pytest.mark.parametrize("l1,l2", [(7, 7), (12, 9), (5, 16)])
def test_profile_align_matches_asm_tpu(rng, l1, l2):
    """tests/test_msa.py's three (l1, l2) cases: one pair at max_len 32,
    four trials each; also the prototype mirror's score and the
    traceback's consumption of exactly (l1, l2)."""
    for _ in range(4):
        a1 = _random_alignment(rng, 2, l1)
        a2 = _random_alignment(rng, 3, l2)
        ts, to = _assert_equal([a1], [a2], 32)
        exp, _, _ = profile_align_ref(a1, a2)
        assert float(ts[0]) == pytest.approx(exp, abs=1e-4)
        ops = to[0][to[0] != 0]
        assert int(((ops == 1) | (ops == 3)).sum()) == l1
        assert int(((ops == 1) | (ops == 4)).sum()) == l2


def test_profile_align_batched(rng):
    als1 = [_random_alignment(rng, 2, 10) for _ in range(6)]
    als2 = [_random_alignment(rng, 2, 11) for _ in range(6)]
    ts, _ = _assert_equal(als1, als2, 32)
    for b in range(6):
        exp, _, _ = profile_align_ref(als1[b], als2[b])
        assert ts[b] == pytest.approx(exp, abs=1e-4)


def test_prototype_example():
    """The prototype's own __main__ example (MSA.py:103) at max_len 16."""
    a1 = ["ACGT-CA", "AGGTCCA"]
    a2 = ["-A-CTCC", "TAGCTCC"]
    ts, _ = _assert_equal([a1], [a2], 16)
    exp, _, _ = profile_align_ref(a1, a2)
    assert float(ts[0]) == pytest.approx(exp, abs=1e-4)


@pytest.mark.parametrize("max_len", [32, 128])
def test_tie_heavy_thirds(rng, max_len):
    """3-row alignments: every column is in thirds, so many cells tie and
    the order of each float sum decides the traceback."""
    lo = max_len // 2
    als1 = [_random_alignment(rng, 3, int(rng.integers(lo, max_len + 1)))
            for _ in range(96)]
    als2 = [_random_alignment(rng, 3, int(rng.integers(lo, max_len + 1)))
            for _ in range(96)]
    ts, _ = _assert_equal(als1, als2, max_len)
    for b in range(0, 96, 24):  # the scalar mirror, on a few pairs
        exp, _, _ = profile_align_ref(als1[b], als2[b])
        assert ts[b] == pytest.approx(exp, abs=1e-4)


@pytest.mark.parametrize("max_len", [16, 129])
def test_mixed_fused_positions(rng, max_len):
    """Lengths where XLA:CPU fuses the per-cell dot everywhere (16) and
    only in the vector loop's scalar tail (129 = 16 x 8 + 1)."""
    als1 = [_random_alignment(rng, 3, int(rng.integers(1, max_len + 1)))
            for _ in range(48)]
    als2 = [_random_alignment(rng, 3, int(rng.integers(1, max_len + 1)))
            for _ in range(48)]
    _assert_equal(als1, als2, max_len)


def test_edge_lengths(rng):
    """Lengths 0, 1 and max_len on both sides (a length-0 profile is an
    alignment of empty rows), and a profile longer than max_len, which
    is cut."""
    L = 32
    lens = [0, 1, L]
    als1, als2 = [], []
    for a in lens:
        for b in lens:
            als1.append(_random_alignment(rng, 2, a))
            als2.append(_random_alignment(rng, 3, b))
    als1.append(_random_alignment(rng, 2, L + 9))
    als2.append(_random_alignment(rng, 2, 5))
    ts, to = _assert_equal(als1, als2, L)
    assert ts[0] == 0.0 and not to[0].any()  # both empty


def test_batch_256_at_128(rng):
    """256 pairs at max_len 128, the size of chip_smoke's phase 15 rows:
    2-4 rows over 64-120 columns, mutated copies of one base."""
    def one():
        return _mutated_alignment(rng, int(rng.integers(2, 5)),
                                  int(rng.integers(64, 121)))
    als1 = [one() for _ in range(256)]
    als2 = [one() for _ in range(256)]
    ts, _ = _assert_equal(als1, als2, 128)
    for b in (0, 255):
        exp, _, _ = profile_align_ref(als1[b], als2[b])
        assert ts[b] == pytest.approx(exp, abs=1e-4)


def test_fma32_is_correctly_rounded(rng):
    """`_fma32` against exact rational arithmetic, rounded to float32."""
    from fractions import Fraction

    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 4).astype(np.float32)
    got = msa._fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    for i in range(2000):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # float64 first: nearest below/above
        cands = {lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))}
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32))
                                         & 1))
        assert got[i] == best, i
