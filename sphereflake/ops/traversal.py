"""Levelwise frontier traversal of the sphereflake in plain XLA.

The reference traverses the 9-ary fractal by per-packet recursive DFS
with movemask early-outs (`Sphereflake.h:86-226`). That shape is hostile
to XLA (dynamic, divergent). The re-design used here:

- **Breadth-first over tree levels.** Every sphere at level L has the
  same radius (root_radius · ratio^L) — the recursion parameter the
  reference threads through calls (`Sphereflake.h:97`) becomes a
  per-level scalar, so a whole level is one batched operation.
- **Batched intersection tests.** For a tile of R rays and a frontier
  of N spheres, `tca` is an [R, N] broadcast product (`_tca`); the rest
  of the reference's intersection math (`SIMD_AVX.h:236-270`) is a
  fused elementwise chain on [R,N].
- **Frontier expansion replaces recursion.** A node is expanded iff some
  ray in the tile wants to recurse into it (bounding-sphere hit + LOD
  cut, `Sphereflake.h:140-153`). Children frames are one batched 3x4
  compose against the 9 template frames (`Sphereflake.h:165-169`).
  Frontiers are compacted to a static capacity with a stable argsort —
  static shapes, jit-friendly.
- **Per-ray gating ("strict" mode).** The reference's self-test gating
  is packet-dependent (a lane is self-tested whenever *any* lane in its
  packet survives the LOD cut). We instead carry an explicit per-ray
  reachability mask, giving deterministic packet-width-independent
  semantics — the packet-width-1 limit of the reference, identical to
  the NumPy golden model.

Everything is differentiable: min-t selection is a masked argmin whose
gathered center carries the gradient (straight-through selection, SURVEY
§7), and the LOD/visit masks are non-differentiable discretizations by
construction.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from sphereflake.config import FractalParams, RenderConfig
from sphereflake.models.sphereflake import child_templates
from sphereflake.ops.intersect import ray_sphere, safe_sqrt
from sphereflake.ops.transforms import rt_multiply

Array = Any
_BIG = np.float32(3.0e38)  # ~FLT_MAX: the reference miss sentinel (host constant)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TraceResult:
    """Per-ray hit state — the G-buffer precursor plus live metrics
    (the reference's counters, `Sphereflake.h:30-58`)."""

    min_t: Array  # [...]: hit distance, _BIG where sky
    center: Array  # [..., 3] center of the winning sphere
    hit: Array  # [...] bool
    max_depth_reached: Array  # [] int32 (`Sphereflake.h:157-160`)
    nodes_visited: Array  # [] int32: frontier slots tested (live counter)
    overflow: Array  # [] int32: nodes dropped by frontier capacity



def _tca(dirs, centers):
    """tca[r, n] = dot(center_n, dir_r) in exact f32.

    Deliberately NOT a matmul: with K=3 a matrix unit does almost no
    work, and a reduced-precision f32 product (bf16 passes or TF32)
    would wreck d2 = |c|^2 - tca^2; five exact-f32 elementwise ops on
    the broadcast [R, N] are bit-stable.
    """
    return (
        dirs[:, 0:1] * centers[None, :, 0]
        + dirs[:, 1:2] * centers[None, :, 1]
        + dirs[:, 2:3] * centers[None, :, 2]
    )


def _level_frontier_sizes(cfg: RenderConfig) -> list[int]:
    """Static frontier capacity per level: 9^L capped at max_frontier
    (rounded to a multiple of 9 past the cap)."""
    sizes = []
    cap = max(9, (cfg.max_frontier // 9) * 9)
    for level in range(cfg.max_depth + 1):
        sizes.append(min(9**level, cap))
    return sizes


@partial(jax.jit, static_argnames=("cfg",))
def trace_tile(
    dirs: Array,
    root: Array,
    templates: Array,
    fractal: FractalParams,
    cfg: RenderConfig,
) -> TraceResult:
    """Trace one tile of rays against the fractal.

    dirs: [R, 3] unit ray directions (origin 0, camera-relative space).
    root: [3, 4] root frame. templates: [9, 3, 4] unit child frames.
    """
    R = dirs.shape[0]
    lod_sq = jnp.float32(cfg.lod_factor**2)
    sizes = _level_frontier_sizes(cfg)

    min_t = jnp.full((R,), _BIG, jnp.float32)
    best_center = jnp.zeros((R, 3), jnp.float32)
    max_depth = jnp.int32(0)
    nodes = jnp.int32(0)
    overflow = jnp.int32(0)

    frames = root[None]  # [1, 3, 4]
    valid = jnp.ones((1,), bool)
    gate = jnp.ones((R, 1), bool) if cfg.strict_lod else None

    radius = fractal.root_radius
    for level in range(cfg.max_depth + 1):
        centers = frames[:, :, 3]  # [N, 3]
        tca = _tca(dirs, centers)
        d2 = jnp.sum(centers * centers, axis=-1)[None, :] - tca * tca

        r_sq = radius * radius
        bhit, tb = ray_sphere(tca, d2, 4.0 * r_sq)  # bounding sphere 2r
        reach = (gate if cfg.strict_lod else jnp.ones((R, 1), bool)) & valid[None, :]
        cont = reach & bhit & (tb < lod_sq * radius)  # LOD cut incl. t<0

        # Self-sphere test (radius r), depth-tested against min_t
        # (`Sphereflake.h:185-225`): within-level masked argmin, then
        # cross-level compare.
        shit, ts = ray_sphere(tca, d2, r_sq)
        ts_masked = jnp.where(cont & shit, ts, _BIG)
        j = jnp.argmin(ts_masked, axis=-1)  # [R]
        t_best = jnp.take_along_axis(ts_masked, j[:, None], axis=-1)[:, 0]
        upd = t_best < min_t
        min_t = jnp.where(upd, t_best, min_t)
        best_center = jnp.where(upd[:, None], centers[j], best_center)

        any_cont = jnp.any(cont, axis=0)  # [N] node wanted by some ray
        max_depth = jnp.where(jnp.any(any_cont), jnp.int32(level), max_depth)
        nodes = nodes + jnp.sum(valid.astype(jnp.int32))

        if level == cfg.max_depth:
            break

        # ---- expansion: frontier level -> level + 1 ----
        n = frames.shape[0]
        n_next = sizes[level + 1]
        scale = (1.0 + fractal.radius_ratio) * radius  # tangent distance
        scaled_tmpl = templates.at[:, :, 3].multiply(scale)  # [9, 3, 4]

        if 9 * n <= n_next:
            # Dense expansion: every child of every node keeps a slot.
            parents = frames
            pgate = gate if cfg.strict_lod else None
            pvalid = any_cont
        else:
            # Compaction: stable-sort wanted nodes to the front, keep
            # the first n_next//9 (static shape), count the drops.
            order = jnp.argsort(~any_cont, stable=True)  # wanted first
            keep = n_next // 9
            parent_idx = order[:keep]
            parents = frames[parent_idx]
            pvalid = any_cont[parent_idx]
            if cfg.strict_lod:
                pgate = jnp.take_along_axis(
                    cont, parent_idx[None, :].repeat(R, 0), axis=1
                )
            overflow = overflow + jnp.sum(any_cont.astype(jnp.int32)) - jnp.sum(
                pvalid.astype(jnp.int32)
            )

        # children frames: [P, 9, 3, 4] -> [9P, 3, 4]
        frames = rt_multiply(parents[:, None], scaled_tmpl[None, :]).reshape(
            -1, 3, 4
        )
        valid = jnp.repeat(pvalid, 9)
        if cfg.strict_lod:
            src = pgate if 9 * n > n_next else cont
            gate = jnp.repeat(src, 9, axis=1)
        radius = radius * fractal.radius_ratio

    return TraceResult(
        min_t=min_t,
        center=best_center,
        hit=min_t < _BIG,
        max_depth_reached=max_depth,
        nodes_visited=nodes,
        overflow=overflow,
    )


def tile_cone(dirs: Array):
    """Bounding cone of a ray tile: (axis [3], cos_half_angle []).

    The replacement for the reference's per-packet movemask early-out
    (`Sphereflake.h:140-144`): a sphere that misses the tile's cone
    misses every ray in the tile, so it can be culled once per tile
    instead of once per ray. Exactly conservative for unit rays from a
    common origin.
    """
    axis = jnp.sum(dirs, axis=0)
    axis = axis / jnp.sqrt(jnp.maximum(jnp.sum(axis * axis), 1e-20))
    cos_theta = jnp.min(jnp.matmul(dirs, axis, precision=jax.lax.Precision.HIGHEST))
    return axis, cos_theta


def _cone_cull(centers, radius, axis, cos_theta, lod_sq):
    """[N] keep-mask: cone-vs-sphere(2r) overlap AND conservative LOD.

    keep iff angle(axis, c) <= theta + asin(min(2r/|c|, 1)) (or origin
    inside the bounding sphere), and the closest possible bounding hit
    |c| - 2r still passes the LOD cut t < lod^2 * r.
    """
    cc = jnp.sum(centers * centers, axis=-1)
    dist = jnp.sqrt(jnp.maximum(cc, 1e-20))
    sin_phi = jnp.minimum(2.0 * radius / dist, 1.0)
    cos_phi = jnp.sqrt(jnp.maximum(1.0 - sin_phi * sin_phi, 0.0))
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    # cos(theta + phi) = cos t cos p - sin t sin p
    cos_sum = cos_theta * cos_phi - sin_theta * sin_phi
    cos_beta = jnp.matmul(centers, axis, precision=jax.lax.Precision.HIGHEST) / dist
    inside = dist <= 2.0 * radius
    hit = inside | (cos_beta >= cos_sum)
    lod_ok = (dist - 2.0 * radius) < lod_sq * radius
    return hit & lod_ok


def _compact(mask, cap: int):
    """Pack indices where mask is true into [cap] slots (cumsum+scatter,
    no sort). Returns (indices [cap], valid [cap],
    dropped [])."""
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slot = jnp.where(mask, pos, cap)  # cap == drop sentinel
    idx = (
        jnp.zeros((cap + 1,), jnp.int32)
        .at[slot]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")[:cap]
    )
    total = jnp.sum(mask.astype(jnp.int32))
    valid = jnp.arange(cap, dtype=jnp.int32) < total
    dropped = jnp.maximum(total - cap, 0)
    return idx, valid, dropped


@partial(jax.jit, static_argnames=("cfg",))
def trace_tile_fast(
    dirs: Array,
    root: Array,
    templates: Array,
    fractal: FractalParams,
    cfg: RenderConfig,
) -> TraceResult:
    """Cone-culled levelwise traversal — the production fast path.

    Differences vs `trace_tile` (the parity path):
    - frontier expansion is decided by the tile's bounding cone (O(nodes)
      per level) instead of any-ray reductions over [rays, nodes];
    - per-ray gating is local to each node (bounding + LOD at the node,
      no ancestor-chain mask), i.e. the packet-style semantics of the
      reference with the tile as the packet. Differences from the strict
      path appear only at LOD horizons and camera-inside-sphere poses.
    """
    R = dirs.shape[0]
    lod_sq = jnp.float32(cfg.lod_factor**2)
    axis, cos_theta = tile_cone(dirs)

    min_t = jnp.full((R,), _BIG, jnp.float32)
    best_center = jnp.zeros((R, 3), jnp.float32)
    max_depth = jnp.int32(0)
    nodes = jnp.int32(0)
    overflow = jnp.int32(0)

    frames = root[None]  # [1, 3, 4]
    valid = jnp.ones((1,), bool)
    radius = fractal.root_radius
    cap = max(9, (cfg.max_frontier // 9) * 9)

    for level in range(cfg.max_depth + 1):
        centers = frames[:, :, 3]  # [N, 3]
        r_sq = radius * radius

        # Fused per-ray test: bounding(2r) + LOD gate + self(r) + min-t.
        tca = _tca(dirs, centers)
        d2 = jnp.sum(centers * centers, axis=-1)[None, :] - tca * tca
        front = (tca >= 0.0) & valid[None, :]
        tb = tca - safe_sqrt(4.0 * r_sq - d2)
        lod_ok = tb < lod_sq * radius
        shit = front & lod_ok & (d2 <= r_sq)
        ts = tca - safe_sqrt(r_sq - d2)
        ts_masked = jnp.where(shit, ts, _BIG)
        j = jnp.argmin(ts_masked, axis=-1)
        t_best = jnp.take_along_axis(ts_masked, j[:, None], axis=-1)[:, 0]
        upd = t_best < min_t
        min_t = jnp.where(upd, t_best, min_t)
        best_center = jnp.where(upd[:, None], centers[j], best_center)

        nodes = nodes + jnp.sum(valid.astype(jnp.int32))
        max_depth = jnp.where(jnp.any(valid), jnp.int32(level), max_depth)

        if level == cfg.max_depth:
            break

        # Expansion: all children of valid nodes -> cone + LOD cull ->
        # compact to capacity.
        scale = (1.0 + fractal.radius_ratio) * radius
        scaled_tmpl = templates.at[:, :, 3].multiply(scale)
        children = rt_multiply(frames[:, None], scaled_tmpl[None, :]).reshape(
            -1, 3, 4
        )  # [9N, 3, 4]
        child_valid = jnp.repeat(valid, 9)
        r_child = radius * fractal.radius_ratio
        keep = child_valid & _cone_cull(
            children[:, :, 3], r_child, axis, cos_theta, lod_sq
        )

        n_next = min(9 * frames.shape[0], cap)
        if children.shape[0] <= n_next:
            frames, valid = children, keep
        else:
            idx, valid, dropped = _compact(keep, n_next)
            frames = children[idx]
            overflow = overflow + dropped
        radius = r_child

    return TraceResult(
        min_t=min_t,
        center=best_center,
        hit=min_t < _BIG,
        max_depth_reached=max_depth,
        nodes_visited=nodes,
        overflow=overflow,
    )


def shade_gbuffer(dirs: Array, res: TraceResult):
    """Turn a TraceResult into (position, normal) G-buffer planes —
    camera-relative position = dir·t, normal = normalize(pos − center),
    zeros for sky (`Sphereflake.cpp:186-201`, sky sentinel consumed at
    `post_ssao.glsl:33`)."""
    t = jnp.where(res.hit, res.min_t, 0.0)
    position = dirs * t[..., None]
    delta = position - res.center
    norm = safe_sqrt(jnp.sum(delta * delta, axis=-1, keepdims=True))
    normal = jnp.where(
        res.hit[..., None], delta / jnp.where(norm > 0, norm, 1.0), 0.0
    )
    position = jnp.where(res.hit[..., None], position, 0.0)
    return position, normal


def tile_tracer(cfg: RenderConfig):
    """Select the XLA traversal implementation for `cfg.algorithm`."""
    if cfg.algorithm == "fast":
        return trace_tile_fast
    if cfg.algorithm in ("strict", "loose"):
        return trace_tile
    if cfg.algorithm == "binned":
        raise ValueError(
            "algorithm 'binned' is the trace-kernel path; it is "
            "dispatched by render_gbuffer and the progressive runtime, "
            "not by the per-tile XLA tracer"
        )
    raise ValueError(f"unknown algorithm {cfg.algorithm!r}")


def trace_rays(
    dirs: Array,
    camera_position: Array,
    fractal: FractalParams,
    cfg: RenderConfig,
) -> TraceResult:
    """Trace an arbitrary ray bundle [..., 3] (flattened into one tile)."""
    from sphereflake.models.sphereflake import root_frame

    shape = dirs.shape[:-1]
    flat = dirs.reshape(-1, 3)
    res = tile_tracer(cfg)(
        flat,
        root_frame(camera_position),
        child_templates(fractal),
        fractal,
        cfg,
    )
    return TraceResult(
        min_t=res.min_t.reshape(shape),
        center=res.center.reshape(*shape, 3),
        hit=res.hit.reshape(shape),
        max_depth_reached=res.max_depth_reached,
        nodes_visited=res.nodes_visited,
        overflow=res.overflow,
    )
