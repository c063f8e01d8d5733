"""The reference's public names in the port, on the CPU.

``repro_torch.core`` exports what ``repro.core`` exports, each name
resolving to the port's counterpart; ``lsh.hamming_scores``,
``pq.adc_scores``, ``metrics.percentile_ms`` and
``kmeans.pad_to_multiple`` are held against the reference's on inputs
made from a seed: Hamming distances, percentiles and pads exactly, ADC
scores to rtol 1e-6 (the reference leaves the order of the M subspace
sums to XLA, the port sums them in order).
"""
from __future__ import annotations

import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

import repro_torch.core as port_core
from repro_torch.core.kmeans import pad_to_multiple
from repro_torch.core.lsh import hamming_scores
from repro_torch.core.metrics import percentile_ms
from repro_torch.core.pq import adc_scores


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def test_core_exports_the_reference_names(reference):
    theirs = importlib.import_module("repro.core")
    assert sorted(port_core.__all__) == sorted(theirs.__all__)
    for name in port_core.__all__:
        value = getattr(port_core, name)
        assert value.__module__.startswith("repro_torch.core."), name
        assert value.__name__ == getattr(theirs, name).__name__
    with pytest.raises(AttributeError):
        port_core.no_such_name


@pytest.mark.parametrize("b,n,w,chunk", [(3, 50, 1, 262144), (5, 1000, 3, 64),
                                         (1, 77, 8, 10)])
def test_hamming_scores_match_reference(reference, b, n, w, chunk):
    rng = _rng(f"hamming {b} {n} {w}")
    q = rng.integers(-2**31, 2**31, size=(b, w), dtype=np.int64)
    c = rng.integers(-2**31, 2**31, size=(n, w), dtype=np.int64)
    q, c = q.astype(np.int32), c.astype(np.int32)
    mine = hamming_scores(torch.as_tensor(q), torch.as_tensor(c), chunk)
    theirs = np.asarray(reference.lsh.hamming_scores(
        jnp.asarray(q), jnp.asarray(c), chunk))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("b,n,m,chunk", [(2, 300, 4, 131072), (4, 1000, 8, 96),
                                         (1, 5, 16, 2)])
def test_adc_scores_match_reference(reference, b, n, m, chunk):
    rng = _rng(f"adc {b} {n} {m}")
    lut = (rng.random((b, m, 256)) * 10).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    mine = adc_scores(torch.as_tensor(lut), torch.as_tensor(codes), chunk)
    theirs = np.asarray(reference.pq.adc_scores(
        jnp.asarray(lut), jnp.asarray(codes), chunk))
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-6)


@pytest.mark.parametrize("q", [50.0, 90.0, 99.0])
def test_percentile_ms_matches_reference(reference, q):
    samples = list(_rng("latency").exponential(0.004, size=257))
    assert percentile_ms(samples, q) == reference.metrics.percentile_ms(
        samples, q)


@pytest.mark.parametrize("shape,m,axis,value", [
    ((10, 3), 4, 0, 0.0), ((8, 3), 4, 0, 0.0), ((5, 7), 3, 1, -1.0),
    ((2, 3, 5), 8, 2, 2.5)])
def test_pad_to_multiple_matches_reference(reference, shape, m, axis, value):
    x = _rng(f"pad {shape}").normal(size=shape).astype(np.float32)
    mine, n = pad_to_multiple(x, m, axis, value)
    theirs, n_ref = reference.kmeans.pad_to_multiple(x, m, axis, value)
    assert n == n_ref
    np.testing.assert_array_equal(mine, np.asarray(theirs))
    assert mine.shape[axis] % m == 0
