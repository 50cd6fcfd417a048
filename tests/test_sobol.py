"""Sobol sampler tests: construction vs the reference's vendored
Gruenschloss/Joe-Kuo table (read from /root/reference when present),
NumPy-vs-JAX agreement, and QMC sanity properties."""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest

from sphereflake.ops.sobol import (
    N_BITS,
    NUM_DIMENSIONS,
    direction_numbers,
    sobol_sample,
    sobol_sample_np,
)

_REF_SOBOL = "/root/reference/sphereflake/Sobol.cpp"


def _reference_table(n_dims):
    """Parse the first n_dims*52 direction numbers from the reference's
    vendored table (verification only — nothing is copied into the repo)."""
    values = []
    with open(_REF_SOBOL) as f:
        text = f.read()
    start = text.index("matrices[Matrices::num_dimensions * Matrices::size]")
    for m in re.finditer(r"0x([0-9A-Fa-f]+)U", text[start:]):
        values.append(int(m.group(1), 16))
        if len(values) >= n_dims * 52:
            break
    return np.array(values, dtype=np.uint32).reshape(n_dims, 52)


@pytest.mark.skipif(not os.path.exists(_REF_SOBOL), reason="reference absent")
def test_direction_numbers_match_reference_table():
    n = NUM_DIMENSIONS
    ref = _reference_table(n)
    ours = direction_numbers()
    np.testing.assert_array_equal(ours, ref[:n, :N_BITS])


@pytest.mark.skipif(not os.path.exists(_REF_SOBOL), reason="reference absent")
def test_samples_match_reference_algorithm():
    # Reproduce Sobol::Sample (Sobol.cpp:41-55) directly from the parsed
    # reference table and compare full-float results.
    ref = _reference_table(2)
    idx = np.array([0, 1, 2, 3, 5, 100, 12345, 2**33 + 17], dtype=np.uint64)
    for dim in (0, 1):
        expect = []
        for i in idx:
            result = np.uint32(777)
            k = 0
            ii = int(i)
            while ii:
                if ii & 1:
                    result ^= ref[dim, k]
                ii >>= 1
                k += 1
            expect.append(float(result) * (1.0 / 2**32))
        got = sobol_sample_np(idx, dim, 777)
        np.testing.assert_allclose(got, expect, rtol=0, atol=0)


def test_jax_matches_numpy():
    idx = np.arange(4096, dtype=np.uint64) * 977 + 3
    for dim in range(NUM_DIMENSIONS):
        a = sobol_sample_np(idx, dim, 0xDEADBEEF)
        b = np.asarray(
            sobol_sample(jnp.asarray(idx & 0xFFFFFFFF, jnp.uint32), dim,
                         0xDEADBEEF,
                         jnp.asarray(idx >> np.uint64(32), jnp.uint32))
        )
        np.testing.assert_allclose(b, a.astype(np.float32), atol=0)


def test_first_values_unscrambled():
    # Sobol dim 0 (van der Corput): 0, 1/2, 1/4, 3/4, 1/8, ...
    got = sobol_sample_np(np.arange(8), 0)
    np.testing.assert_allclose(got, [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])
    # dim 1: standard Sobol second dimension: 0, 1/2, 3/4, 1/4, ...
    got1 = sobol_sample_np(np.arange(4), 1)
    np.testing.assert_allclose(got1, [0, 0.5, 0.75, 0.25])


def test_stratification_property():
    # Any 2^k prefix of a (0,2)-sequence pair of dims covers every
    # elementary interval once: check 2D stratification on a 16x16 grid
    # over 256 samples.
    n = 256
    x = sobol_sample_np(np.arange(n), 0)
    y = sobol_sample_np(np.arange(n), 1)
    cells = set(zip((x * 16).astype(int), (y * 16).astype(int)))
    assert len(cells) == 256
