"""Device-mesh construction for screen-tile parallelism.

The reference's parallelism is N identical worker threads statistically
sharding the pixel stream over shared memory (`Sphereflake.cpp:67-74`).
The equivalent here is a 2D device mesh over screen tiles: rays are
embarrassingly parallel in the forward pass, so the only collectives
are metric reductions (psum/pmin/pmax) and gradient all-reduce in the
backward pass.

Multi-host: build the mesh from `jax.devices()` after
`jax.distributed.initialize()`; the tile assignment is
placement-invariant (tile index = mesh coordinates), so N-host output
equals 1-host output (SURVEY §7 determinism requirement).
"""

from __future__ import annotations

import math

import jax
from jax.sharding import Mesh


def make_mesh(devices=None, shape=None, axis_names=("ty", "tx")) -> Mesh:
    """A 2D (rows x cols) device mesh for screen-tile sharding.

    shape defaults to the most-square factorization of the device count
    (favoring more row-bands, which keeps per-device image slices
    contiguous).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if shape is None:
        rows = 1
        for cand in range(int(math.isqrt(n)), 0, -1):
            if n % cand == 0:
                rows = n // cand
                break
        shape = (rows, n // rows)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    import numpy as np

    return Mesh(np.asarray(devices).reshape(shape), axis_names)
