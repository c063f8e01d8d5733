"""The Hamming kernel's histogram select, modelled in numpy on the CPU.

``csrc/hamming_topk.cu`` splits N into the splits of ``hamming.plan``,
takes queries in groups of ``G``, counts each (query, split)'s rows per
distance, finds each query's threshold bin, turns the counts into output
offsets and emits the rows at or under the threshold in (split, chunk,
run of 32, lane) order, ranking a run's lanes of equal distance.  The
model below follows that partition step for step (the kernel itself runs
only on the card) and must equal the plain version
``ref.hamming_topk_ref``, a stable sort of the flat scan, bit for bit:
ids and distances, on the ties of one-word codes, at k on and next to
the threshold bin's running count, at k = N, with fewer live rows than
k, with every row dead, and with the threshold bin spread over several
splits.  ``plan`` is held to its promises for B up to 65,535 and N up to
10M: no empty split, whole runs, a card filled at B = 1 and B = 1,024,
and a count table of bounded size.
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import hamming, ref

H100_SMS = 132


def _constants() -> dict:
    text = (pathlib.Path(hamming.__file__).with_name("csrc")
            / "hamming_topk.cu").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}


C = _constants()


def _distances(q: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """(B, N) int64 Hamming distances of packed int32 words."""
    x = q.view(np.uint32)[:, None, :] ^ codes.view(np.uint32)[None, :, :]
    return np.bitwise_count(x).sum(-1).astype(np.int64)


def model_select(q, codes, valid, k, sm_count=H100_SMS):
    """The kernel's three passes over its (query group, split, chunk, run)
    partition; returns (dists (B, k) float32, ids (B, k) int32) and the
    per-(query, split, bin) counts."""
    b, w = q.shape
    n = codes.shape[0]
    k_eff = min(k, n)
    bins = 32 * w + 1
    groups, splits, rows = hamming.plan(b, n, sm_count)
    assert groups == -(-b // C["G"])
    dist = _distances(q, codes)
    live = np.ones(n, bool) if valid is None else valid != 0
    bounds = [(s * rows, min(n, (s + 1) * rows)) for s in range(splits)]

    # 1. count: every (query, split)'s live rows per distance
    hist = np.zeros((b, splits, bins), np.int64)
    for s, (r0, r1) in enumerate(bounds):
        for c0 in range(r0, r1, C["CH"]):
            c1 = min(r1, c0 + C["CH"])
            for qb in range(b):
                d = dist[qb, c0:c1][live[c0:c1]]
                hist[qb, s] += np.bincount(d, minlength=bins)

    # 2. offsets: the threshold bin, each (split, bin)'s first slot, and
    # the sentinel past the live rows
    out_d = np.full((b, k_eff), np.nan, np.float32)
    out_i = np.full((b, k_eff), -7, np.int32)
    total = hist.sum(1)
    cum = np.cumsum(total, axis=1)
    thr = np.where(cum[:, -1] >= k_eff, np.argmax(cum >= k_eff, axis=1),
                   bins - 1)
    start = cum - total                                  # before bin d
    offs = start[:, None, :] + np.cumsum(hist, axis=1) - hist
    for qb in range(b):
        out_d[qb, cum[qb, -1]:] = np.inf
        out_i[qb, cum[qb, -1]:] = -1

    # 3. emit: each split's runs of 32 rows in order; a run with no row at
    # or under the bound is passed over; the others rank their lanes of
    # equal distance (lanes in id order) after the (split, bin) offset.
    # The bound starts at the threshold bin and drops below it once that
    # bin's offset reaches k.
    lanes = np.arange(32)
    for qb in range(b):
        for s, (r0, r1) in enumerate(bounds):
            nxt = offs[qb, s].copy()
            bound = thr[qb] - (nxt[thr[qb]] >= k_eff)
            for c0 in range(r0, r1, C["CH"]):
                for run in range(c0, min(r1, c0 + C["CH"]), 32):
                    r = run + lanes
                    ok = r < r1
                    d = np.where(ok, dist[qb, np.minimum(r, n - 1)], bins)
                    hit = ok & live[np.minimum(r, n - 1)] & (d <= bound)
                    if not hit.any():
                        continue
                    for lane in np.flatnonzero(hit):
                        same = hit[:lane] & (d[:lane] == d[lane])
                        slot = nxt[d[lane]] + int(same.sum())
                        if slot < k_eff:
                            out_d[qb, slot] = d[lane]
                            out_i[qb, slot] = r[lane]
                    for dd in np.unique(d[hit]):
                        nxt[dd] += int((d[hit] == dd).sum())
                    bound -= nxt[bound] >= k_eff
    assert not np.isnan(out_d).any() and (out_i != -7).all()
    pad = k - k_eff
    out_d = np.concatenate([out_d, np.full((b, pad), np.inf, np.float32)], 1)
    out_i = np.concatenate([out_i, np.full((b, pad), -1, np.int32)], 1)
    return out_d, out_i, hist, thr


def _operands(seed, b, n, w, rows=None, same_query=False):
    rng = np.random.default_rng([seed, b, n, w])
    q = rng.integers(-2**31, 2**31, size=(b, w)).astype(np.int32)
    if same_query:
        q[:] = q[0]
    codes = rng.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)
    valid = None
    if rows == "half":
        valid = (rng.random(n) > 0.5).astype(np.int32)
    elif rows == "dead":
        valid = np.zeros(n, np.int32)
    elif rows == "few":
        valid = (rng.random(n) < 0.01).astype(np.int32)
    return q, codes, valid


def _check(q, codes, valid, k, sm_count=H100_SMS):
    md, mi, hist, thr = model_select(q, codes, valid, k, sm_count)
    v = None if valid is None else torch.as_tensor(valid)
    pd, pi = ref.hamming_topk_ref(torch.as_tensor(q), torch.as_tensor(codes),
                                  k, valid=v)
    assert pi.numpy().tobytes() == mi.tobytes()
    assert pd.numpy().tobytes() == md.tobytes()
    return hist, thr


@pytest.mark.parametrize("case", [
    ("W=1 ties", 5, 3000, 1, 64, None),
    ("W=3 two groups", 40, 5000, 3, 100, "half"),
    ("W=8", 3, 2500, 8, 33, None),
    ("k=N", 4, 700, 2, 700, "half"),
    ("k>N", 3, 50, 3, 80, None),
    ("fewer live than k", 6, 3000, 3, 128, "few"),
    ("all dead", 4, 600, 3, 10, "dead"),
    ("B=1 k=1", 1, 4000, 3, 1, None),
], ids=lambda c: c[0])
def test_model_equals_the_plain_version(case):
    _, b, n, w, k, rows = case
    q, codes, valid = _operands(1, b, n, w, rows)
    _, thr = _check(q, codes, valid, k)
    if rows == "dead":
        assert (thr == 32 * w).all()


@pytest.mark.parametrize("shift", [-1, 0, 1],
                         ids=["below", "at", "above"])
def test_k_at_the_threshold_bins_running_count(shift):
    """k one below, at and one above the running count that ends a bin:
    the threshold bin is that bin, that bin and the next."""
    q, codes, valid = _operands(2, 3, 4000, 1, "half", same_query=True)
    d = _distances(q[:1], codes)[0][valid != 0]
    cum = np.cumsum(np.bincount(d, minlength=33))
    edge = int(cum[14])
    assert cum[13] < edge - 1 and cum[15] > edge + 1
    _, thr = _check(q, codes, valid, edge + shift)
    assert (thr == (15 if shift > 0 else 14)).all()


def test_threshold_bin_split_across_splits():
    """One-word codes over several splits: the threshold bin's rows lie in
    every split, and each split's share takes its slots after the
    earlier splits'."""
    q, codes, valid = _operands(3, 2, 9000, 1, None)
    groups, splits, _ = hamming.plan(2, 9000, H100_SMS)
    assert splits >= 3
    hist, thr = _check(q, codes, valid, 500)
    for qb in range(2):
        assert (hist[qb, :, thr[qb]] > 0).sum() >= 3


def test_model_with_many_splits_and_groups():
    """A small card (8 SMs) at B = 70: three groups, the last partly
    empty, over splits of a few hundred rows."""
    q, codes, valid = _operands(4, 70, 3000, 2, "half")
    groups, splits, rows = hamming.plan(70, 3000, 8)
    assert groups == 3 and splits >= 1
    _check(q, codes, valid, 40, sm_count=8)


def test_kernel_constants_match_the_wrapper():
    assert C["G"] == hamming.G == 32
    assert C["BLOCKS_PER_SM"] == hamming.BLOCKS_PER_SM
    assert C["MAX_W"] == hamming.MAX_W
    assert C["CH"] % 32 == 0 and hamming.RUN == 32


@pytest.mark.parametrize("b", [1, 2, 31, 32, 33, 70, 1000, 1024, 4096,
                               16896, 65535])
def test_plan_covers_every_batch_and_corpus(b):
    for n in (1, 31, 32, 33, 2047, 2048, 2049, 100_000, 1_000_000,
              10_000_000):
        groups, s, rows = hamming.plan(b, n, H100_SMS)
        assert groups == -(-b // hamming.G) <= 65535
        assert s >= 1 and rows % hamming.RUN == 0
        assert (s - 1) * rows < n <= s * rows          # no empty split
        # the count table (B, splits, 257) stays bounded: at most the
        # larger of B and G blocks' worth of one wave
        assert b * s <= max(b, hamming.G * hamming.BLOCKS_PER_SM * H100_SMS)
        assert groups * s <= max(groups, hamming.BLOCKS_PER_SM * H100_SMS)
        if n >= hamming.MIN_ROWS * H100_SMS:
            assert groups * s >= H100_SMS               # the card is filled


def test_plan_at_the_main_shapes():
    assert hamming.plan(1024, 1_000_000, H100_SMS) == (32, 16, 62528)
    assert hamming.plan(1, 1_000_000, H100_SMS) == (1, 489, 2048)
