"""Sobol quasi-Monte-Carlo sampler (vectorized JAX + NumPy).

The reference vendors Gruenschloss' scalar implementation of Joe-Kuo
(2008) direction numbers — 1024 dims x 52 bits — and evaluates one
sample at a time (`Sobol.cpp:41-55`):

    result = scramble;  for each set bit i of index: result ^= M[dim][i]
    return result * 2^-32

Here the direction numbers are *constructed* from the standard primitive
polynomial recurrence (same construction that produced the Joe-Kuo
table) instead of vendoring the 53k-line table, and evaluation is a
vectorized XOR-fold over index bits — one [B]-shaped jnp computation per
dimension. The renderer itself uses dims 0-1 (pixel x/y,
`Sphereflake.cpp:139-140`); more dims are available for extensions.

Direction-number construction: dim 0 is the van der Corput sequence
(identity matrix, v_k = 2^(31-k)); dim j>=1 uses the degree-s primitive
polynomial with encoded coefficient `a` and initial odd values m_1..m_s:

    v_k = m_k << (32-k)                       for k <= s
    v_k = v_{k-s} ^ (v_{k-s} >> s) ^ XOR_{i=1}^{s-1} a_i * v_{k-i}   else

The full 1023-dimension parameter set (matching the reference's 1024
dims, `Sobol.cpp:35`) lives in `_joekuo.py` — published Joe-Kuo
mathematical constants in compact (s, a, m) form, verified bit-exact
against the expanded table by `tools/extract_joekuo.py`. Dims 0-1 are
additionally cross-checked against the reference semantics by the test
suite.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from sphereflake.ops._joekuo import JOE_KUO_PARAMS as _JOE_KUO

N_BITS = 52  # index bits supported, like the reference table (Sobol.cpp:37)

NUM_DIMENSIONS = len(_JOE_KUO) + 1  # 1024, matching Sobol.cpp:35


@functools.lru_cache(maxsize=1)
def direction_numbers() -> np.ndarray:
    """[NUM_DIMENSIONS, N_BITS] uint32 direction-number matrix."""
    out = np.zeros((NUM_DIMENSIONS, N_BITS), dtype=np.uint32)
    # dim 0: van der Corput — identity bit matrix; bits past 32 are 0
    for k in range(min(32, N_BITS)):
        out[0, k] = np.uint32(1) << np.uint32(31 - k)
    for d, (s, a, m) in enumerate(_JOE_KUO, start=1):
        v = np.zeros(N_BITS, dtype=np.uint64)
        for k in range(N_BITS):
            if k < s:
                v[k] = np.uint64(m[k]) << np.uint64(31 - k)
            else:
                val = v[k - s] ^ (v[k - s] >> np.uint64(s))
                for i in range(1, s):
                    if (a >> (s - 1 - i)) & 1:
                        val ^= v[k - i]
                v[k] = val
        out[d] = v.astype(np.uint32)
    return out


def sobol_sample_np(index, dim: int, scramble=0) -> np.ndarray:
    """NumPy golden evaluation, bit-identical to `Sobol.cpp:41-55`."""
    index = np.asarray(index, dtype=np.uint64)
    scramble = np.asarray(scramble, dtype=np.uint32)
    dirs = direction_numbers()[dim]
    result = np.broadcast_to(scramble, index.shape).copy()
    for i in range(N_BITS):
        bit = ((index >> np.uint64(i)) & np.uint64(1)).astype(bool)
        result ^= np.where(bit, dirs[i], np.uint32(0))
    return result.astype(np.float64) * float(2.0**-32)


def sobol_sample(index_lo, dim: int, scramble=0, index_hi=0):
    """Vectorized JAX evaluation.

    jax defaults to 32-bit integers, so the 52-bit sample index is passed
    as two uint32 halves (index = index_hi * 2^32 + index_lo); index_hi
    may be a scalar 0 for streams shorter than 2^32 samples. `dim` is a
    static int; scramble broadcasts as uint32. Returns float32 in [0, 1).
    """
    row = jnp.asarray(direction_numbers()[dim])  # [N_BITS] uint32
    if isinstance(index_lo, int):
        index_lo = np.uint32(index_lo)
    if isinstance(index_hi, int):
        index_hi = np.uint32(index_hi)
    if isinstance(scramble, int):
        scramble = np.uint32(scramble)
    index_lo = jnp.asarray(index_lo).astype(jnp.uint32)
    index_hi = jnp.asarray(index_hi).astype(jnp.uint32)
    result = jnp.broadcast_to(
        jnp.asarray(scramble).astype(jnp.uint32), index_lo.shape
    )
    for i in range(min(32, N_BITS)):
        bit = (index_lo >> jnp.uint32(i)) & jnp.uint32(1)
        result = result ^ jnp.where(bit.astype(bool), row[i], jnp.uint32(0))
    for i in range(32, N_BITS):
        bit = (index_hi >> jnp.uint32(i - 32)) & jnp.uint32(1)
        result = result ^ jnp.where(bit.astype(bool), row[i], jnp.uint32(0))
    return result.astype(jnp.float32) * jnp.float32(2.0**-32)
