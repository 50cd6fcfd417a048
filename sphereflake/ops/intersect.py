"""Ray-sphere intersection primitives (jnp, differentiable).

Semantics match `SIMD_AVX.h:236-270` exactly, with the ray origin at 0
(folded into the root transform, `Sphereflake.cpp:83`):

    tca = dot(center, dir)            reject tca < 0 (center behind)
    d²  = dot(center, center) - tca²  reject d² > radius²
    thc = sqrt(radius² - d²)
    t   = tca - thc                   (the reference's mask-select
                                       min(tca+thc, tca-thc) reduces to
                                       this since thc >= 0; negative t
                                       for origin-inside rays is kept,
                                       reproducing the documented
                                       camera-inside-sphere behavior)

Gradient-safe: sqrt is guarded so tangent hits don't produce NaN grads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def safe_sqrt(x):
    """sqrt(max(x, 0)) with zero gradient at/below 0 (no NaNs)."""
    positive = x > 0
    return jnp.where(positive, jnp.sqrt(jnp.where(positive, x, 1.0)), 0.0)


def ray_sphere(tca, d2, radius_sq):
    """Shared-precompute intersection: given tca = dirs·c and
    d² = |c|² − tca², return (hit, t) for a sphere of squared radius
    radius_sq. Broadcasts over any shape."""
    hit = (tca >= 0.0) & (d2 <= radius_sq)
    t = tca - safe_sqrt(radius_sq - d2)
    return hit, t


def ray_sphere_full(dirs, center, radius_sq):
    """Standalone form: dirs [..., 3] (unit), center [3] (origin at 0)."""
    hi = jax.lax.Precision.HIGHEST
    tca = jnp.matmul(dirs, center, precision=hi)
    d2 = jnp.dot(center, center, precision=hi) - tca * tca
    return ray_sphere(tca, d2, radius_sq)
