"""Path codes: the trace kernel's discrete hit payload, and the plain-XLA
functions that read it.

A winner's path code is its sentinel-prefixed base-9 tree path (root =
1, child j of code c = 9c + j), so its level is floor(log9 code).
`resolve_codes_soa` re-derives the winning sphere's frame and the
analytic hit distance differentiably from the code — the
straight-through selection (SURVEY §7 stage 5) that lets `jax.grad`
flow through the binned path with no backward kernel.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from sphereflake.config import FractalParams, RenderConfig
from sphereflake.ops.intersect import safe_sqrt

Array = Any
_BIG = np.float32(3.0e38)

TILE_RAYS = 1024  # rays per screen tile: one trace-kernel program's block


def resolve_codes_soa(
    dx: Array,  # [N] unit ray direction components
    dy: Array,
    dz: Array,
    code_f: Array,  # [N] f32 sentinel path codes (lo lane) from the kernel
    root: Array,  # [3, 4]
    templates: Array,  # [9, 3, 4]
    fractal: FractalParams,
    cfg: RenderConfig,
    code_hi_f: Array | None = None,  # [N] f32 hi lane (depth > 7)
):
    """Differentiably re-derive each ray's winning sphere from its path
    code, fully SoA: returns (min_t, cx, cy, cz, hit), each [N].

    This is the straight-through backward surface (SURVEY §7 stage 5):
    the *discrete* winner choice comes from the kernel (stop-gradient by
    construction); the winner's frame is re-composed from the templates
    and the analytic ray-sphere distance (`SIMD_AVX.h:236-270`) is
    recomputed in XLA, so `jax.grad` flows into camera pose, fractal
    geometry and radii exactly as it does through the strict XLA path.

    Codes ride two lanes for depth > 7: full code = hi * 9^7 + lo
    (sentinel-prefixed, so level = floor(log9) of the combination);
    base-9 digit extraction never needs the sentinel stripped because
    it always lands above the `% 9`.
    """
    lo = jax.lax.stop_gradient(code_f).astype(jnp.int32).reshape(-1)
    if code_hi_f is None:
        hi = jnp.zeros_like(lo)
    else:
        hi = jax.lax.stop_gradient(code_hi_f).astype(jnp.int32).reshape(-1)
    hit = (lo >= 1) | (hi >= 1)

    depth = cfg.max_depth
    pow9 = [9**k for k in range(8)]  # 9^7 is the largest ever indexed
    # level = floor(log9 code): count thresholds passed per lane.
    level = jnp.zeros_like(lo)
    for k in range(1, min(depth, 7) + 1):
        level = level + ((hi == 0) & (lo >= pow9[k])).astype(jnp.int32)
    # hi carries from LEVEL 7 onward (expand_global splits at 9^7
    # unconditionally), so the hi-lane level count runs at depth == 7
    # too — `depth > 7` here would drop every level-7 winner.
    for k in range(0, max(depth - 7, 0) + 1 if depth >= 7 else 0):
        level = level + (hi >= pow9[k]).astype(jnp.int32) * (
            7 if k == 0 else 1
        )
    pow_tab = jnp.asarray(pow9, jnp.int32)

    ratio = fractal.radius_ratio
    radius0 = fractal.root_radius

    # SoA frame walk: 12 per-ray component arrays instead of [N, 3, 4]
    # tensors, so every step is an elementwise FMA chain over [N] (no
    # tiny batched 3x3 products). The math is `rt_multiply` unrolled
    # per component.
    n = lo.shape[0]
    r = [jnp.broadcast_to(root[a, b], (n,)) for a in range(3) for b in range(3)]
    t = [jnp.broadcast_to(root[a, 3], (n,)) for a in range(3)]
    radius = radius0
    for k in range(depth):
        # Base-9 digit for expansion step k (most significant first):
        # digit m = level-1-k powers above the bottom; taken from hi
        # when m >= 7 (the sentinel always sits above the % 9).
        m = jnp.maximum(level - 1 - k, 0)
        d_lo = (lo // jnp.take(pow_tab, jnp.minimum(m, 7))) % 9
        if depth > 7:
            d_hi = (hi // jnp.take(pow_tab, jnp.maximum(m - 7, 0))) % 9
            d = jnp.where(m >= 7, d_hi, d_lo)
        else:
            d = d_lo
        scale = (1.0 + ratio) * radius
        oh = [(d == j).astype(jnp.float32) for j in range(9)]
        # Selected template entries per ray (rotation + scaled disp).
        e = [
            sum(oh[j] * templates[j, a, b] for j in range(9))
            for a in range(3)
            for b in range(3)
        ]
        disp = [
            sum(oh[j] * templates[j, a, 3] for j in range(9)) * scale
            for a in range(3)
        ]
        take = (k < level).astype(jnp.float32)
        keep = 1.0 - take
        new_r = [
            sum(r[3 * a + kk] * e[3 * kk + b] for kk in range(3))
            for a in range(3)
            for b in range(3)
        ]
        new_t = [
            sum(r[3 * a + kk] * disp[kk] for kk in range(3)) + t[a]
            for a in range(3)
        ]
        r = [take * nr + keep * rr for nr, rr in zip(new_r, r)]
        t = [take * nt + keep * tt for nt, tt in zip(new_t, t)]
        radius = radius * ratio

    cx, cy, cz = t
    r_hit = radius0 * fractal.radius_ratio ** level.astype(jnp.float32)
    tca = dx * cx + dy * cy + dz * cz
    d2 = cx * cx + cy * cy + cz * cz - tca * tca
    tt = tca - safe_sqrt(r_hit * r_hit - d2)
    min_t = jnp.where(hit, tt, _BIG)
    hf = hit.astype(jnp.float32)
    return min_t, cx * hf, cy * hf, cz * hf, hit


def depth_reached_soa(code_f: Array, cfg: RenderConfig,
                      code_hi_f: Array | None = None) -> Array:
    """Max fractal level present in a batch of (lo, hi) path codes —
    the reference's `m_MaxDepthReached` (`Sphereflake.h:157-160`)."""
    lo = jnp.max(code_f).astype(jnp.int32)
    depth = jnp.zeros((), jnp.int32)
    for k in range(1, min(cfg.max_depth, 7) + 1):
        depth = depth + (lo >= 9**k).astype(jnp.int32)
    if cfg.max_depth >= 7 and code_hi_f is not None:
        hi = jnp.max(code_hi_f).astype(jnp.int32)
        deep = jnp.zeros((), jnp.int32)
        for k in range(1, cfg.max_depth - 7 + 1):
            deep = deep + (hi >= 9**k).astype(jnp.int32)
        depth = jnp.where(hi >= 1, 7 + deep, depth)
    return depth


def resolve_codes(
    dirs: Array,  # [..., 3] unit ray directions
    code_f: Array,  # [...] f32 sentinel path codes from the kernel
    root: Array,
    templates: Array,
    fractal: FractalParams,
    cfg: RenderConfig,
    code_hi_f: Array | None = None,
):
    """AoS wrapper over `resolve_codes_soa`:
    (min_t [...], center [..., 3], hit [...])."""
    shape = code_f.shape
    flat = dirs.reshape(-1, 3)
    min_t, cx, cy, cz, hit = resolve_codes_soa(
        flat[:, 0], flat[:, 1], flat[:, 2], code_f.reshape(-1),
        root, templates, fractal, cfg,
        code_hi_f=None if code_hi_f is None else code_hi_f.reshape(-1),
    )
    center = jnp.stack([cx, cy, cz], axis=-1)
    return (
        min_t.reshape(shape),
        center.reshape(*shape, 3),
        hit.reshape(shape),
    )
