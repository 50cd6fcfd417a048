"""Shared-bin sharded rendering: bin the frame ONCE, shard the heavy
stages — the strong-scaling fix for single small frames.

The per-block sharded path (`parallel/sharded.py`) has every device
re-expand and re-bin its own block; the bin stage's cost barely shrinks
with block size (caps are frame-sized, per-op overheads fixed), so
strong scaling of one small frame stalls on the replicated bin. The
reference's threads never had this problem: they all read ONE shared
scene (`Sphereflake.cpp:69`). This module is the equivalent — one
logical bin, cooperatively computed:

- **Replicated (identical on every device, no communication):** tree
  expansion, the per-node pair-slot geometry (`ops.binned.bin_geometry`
  — all elementwise), the packed-key sort, and the tile-segment
  searchsorted. These are the cheap or unshardable stages.
- **Sharded by pair-slot window:** the scatter+running-max fill/decode
  (`_decode_tiles_window` with a per-device window; the running-max
  carry-in at a window boundary is an exact int32 masked reduction
  over the node arrays, so windows compose BIT-identically to the full
  scan) and the fat-rows pair gather — the two data-bound stages that
  dominate the bin. Each device computes its `pair_cap / D` slot
  window and the windows ride two all-gathers.
- **Sharded by tile block:** the trace kernel (each device traces its
  own 2D block of tiles through `trace_pairs`' tile-id indirection)
  and the untile — exactly 1/D of the math each.

Because every stage is either bit-identically replicated or an exact
window decomposition, the output equals the single-device
`render_gbuffer` BIT-FOR-BIT (pinned by tests/test_sharded.py).

Differentiability: the forward pass uses collectives and the raw
kernel, so a custom JVP re-derives tangents from the saved path codes
via `resolve_codes_soa` over the full frame (replicated backward —
the sharded-backward fitting path remains `fit_step_sharded`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sphereflake.config import RenderConfig, SceneParams
from sphereflake.ops.traversal import _BIG

Array = Any


def shared_bin_supported(cfg: RenderConfig, mesh: Mesh) -> bool:
    """The shared-bin path needs: binned algorithm, no banding (large
    frames amortize the bin anyway), tile grid divisible by the mesh,
    pair_cap divisible by the device count, and the packed sort key to
    fit 31 bits."""
    my, mx = mesh.devices.shape
    d = my * mx
    if cfg.algorithm != "binned" or cfg.effective_band_rows is not None:
        return False
    if cfg.tiles_y % my or cfg.tiles_x % mx or cfg.pair_cap % d:
        return False
    n_tiles = cfg.tiles_x * cfg.tiles_y
    # node-count bound used by the packed sort key (levels concatenated)
    n_nodes_max = 0
    width = 1
    for _ in range(cfg.max_depth + 1):
        n_nodes_max += min(width, cfg.global_cap)
        width *= 9
    node_bits = max(1, (n_nodes_max - 1).bit_length())
    tile_bits = (n_tiles + 1).bit_length()
    return node_bits + tile_bits <= 31


def _block_tile_ids(cfg: RenderConfig, my, mx, iy, ix):
    """Global frame tile ids of device (iy, ix)'s block, row-major."""
    bty, btx = cfg.tiles_y // my, cfg.tiles_x // mx
    ly = jnp.arange(bty, dtype=jnp.int32)[:, None]
    lx = jnp.arange(btx, dtype=jnp.int32)[None, :]
    gids = (iy * bty + ly) * cfg.tiles_x + (ix * btx + lx)
    return gids.reshape(bty * btx)


def _shared_primal(statics, scene):
    """Forward pass; returns full-frame CROPPED [H, W(,3)] planes
    (position, normal, min_t, hit_f, lo, hi) + scalar metrics (f32)."""
    cfg, mesh = statics
    my, mx = mesh.devices.shape
    D = my * mx
    capD = cfg.pair_cap // D
    n_tiles = cfg.tiles_x * cfg.tiles_y
    bty, btx = cfg.tiles_y // my, cfg.tiles_x // mx
    bcfg = dataclasses.replace(
        cfg, height=bty * cfg.tile_h, width=btx * cfg.tile_w
    )
    deep = cfg.max_depth >= 7

    from sphereflake.camera import corner_rays, tile_frustum_planes
    from sphereflake.models.sphereflake import child_templates, root_frame
    from sphereflake.ops.binned import (
        _BIG as BIGF,
        _decode_tiles_window,
        bin_geometry,
        camera_vector,
        corner_basis,
        expand_global,
        node_rows,
        trace_pairs,
    )
    from sphereflake.ops.codes import depth_reached_soa
    from sphereflake.render import _untile_rows

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=(
            P("ty", "tx"),  # min_t
            P("ty", "tx"),  # px
            P("ty", "tx"),  # py
            P("ty", "tx"),  # pz
            P("ty", "tx"),  # nx
            P("ty", "tx"),  # ny
            P("ty", "tx"),  # nz
            P("ty", "tx"),  # lo
            P("ty", "tx"),  # hi
            P(),  # depth_reached
            P(),  # nodes_visited
            P(),  # overflow
        ),
        check_vma=False,
    )
    def run(scene):
        iy = jax.lax.axis_index("ty")
        ix = jax.lax.axis_index("tx")
        d = iy * mx + ix

        # ---- replicated: expansion + per-node geometry (elementwise)
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        frame_planes = tile_frustum_planes(
            scene.camera, cfg.width, cfg.height,
            cfg.padded_height, cfg.padded_width,
            block_h=cfg.padded_height, block_w=cfg.padded_width,
        )[0]
        nodes, exp_ovf = expand_global(
            root, templates, scene.fractal, cfg, frame_planes
        )
        minv = corner_basis(scene.camera, cfg.width, cfg.height)
        origin, tl, tr, bl = corner_rays(
            scene.camera, cfg.width / cfg.height
        )
        ex, ey = tr - tl, bl - tl
        u1 = jnp.float32(cfg.padded_width / cfg.width)
        v1 = jnp.float32(cfg.padded_height / cfg.height)
        base = tl - origin
        corners = jnp.stack(
            [base + u * ex + v * ey
             for u in (jnp.float32(0.0), u1) for v in (jnp.float32(0.0), v1)]
        )
        geo = bin_geometry(nodes, minv, cfg, corners=corners)

        # ---- sharded fill/decode: my slot window, exact carry-in
        lo_slot = d * capD
        tile_w_, node_w = _decode_tiles_window(geo, cfg, lo_slot, capD)
        n_nodes = geo["n_nodes"]
        node_bits = max(1, (n_nodes - 1).bit_length())
        packed_w = (tile_w_ << node_bits) | node_w
        packed = jax.lax.all_gather(packed_w, "tx", axis=0, tiled=True)
        packed = jax.lax.all_gather(packed, "ty", axis=0, tiled=True)

        # ---- replicated: one packed sort + tile segments
        packed = jax.lax.sort(packed)
        tile_sorted = packed >> node_bits
        bounds = jnp.searchsorted(
            tile_sorted, jnp.arange(n_tiles + 1, dtype=jnp.int32)
        )
        starts = bounds[:-1].astype(jnp.int32)
        lens = (bounds[1:] - bounds[:-1]).astype(jnp.int32)

        # ---- sharded: fat-rows gather over my sorted-slot window
        rows = node_rows(nodes, cfg)
        node_sorted_w = jax.lax.dynamic_slice(
            packed, (lo_slot,), (capD,)
        ) & ((1 << node_bits) - 1)
        dead_w = jax.lax.dynamic_slice(
            tile_sorted, (lo_slot,), (capD,)
        ) >= n_tiles
        pairs_w = rows[:, node_sorted_w]
        pairs_w = pairs_w.at[3, :].set(
            jnp.where(dead_w, -BIGF, pairs_w[3, :])
        )
        pairs = jax.lax.all_gather(pairs_w, "tx", axis=1, tiled=True)
        pairs = jax.lax.all_gather(pairs, "ty", axis=1, tiled=True)

        # ---- sharded: trace kernel on my tile block + untile
        cam = camera_vector(scene, cfg)
        gids = _block_tile_ids(cfg, my, mx, iy, ix)
        out = trace_pairs(pairs, starts, lens, cfg, cam=cam, tile_ids=gids)
        imgs = _untile_rows(out, bcfg)  # block-local [bh, bw] planes
        min_t = imgs[0]
        lo_img = imgs[1]
        hi_img = imgs[2] if deep else jnp.zeros_like(lo_img)
        pn = imgs[3:9] if deep else imgs[2:8]

        depth_r = depth_reached_soa(
            lo_img.reshape(-1), cfg,
            hi_img.reshape(-1) if deep else None,
        )
        depth_r = jax.lax.pmax(jax.lax.pmax(depth_r, "ty"), "tx")
        nodes_n = jnp.sum(lens[gids])
        nodes_n = jax.lax.psum(jax.lax.psum(nodes_n, "ty"), "tx")
        # exp/pair overflow is computed REPLICATED — no reduction.
        overflow = (geo["pair_overflow"] + exp_ovf).astype(jnp.int32)
        return (
            min_t, pn[0], pn[1], pn[2], pn[3], pn[4], pn[5],
            lo_img, hi_img,
            depth_r.astype(jnp.float32),
            nodes_n.astype(jnp.float32),
            overflow.astype(jnp.float32),
        )

    (min_t, px, py, pz, nx, ny, nz, lo_img, hi_img,
     depth_r, nodes_n, overflow) = run(scene)
    h, w = cfg.height, cfg.width
    crop = lambda a: a[:h, :w]
    hit = crop(min_t) < _BIG
    return (
        jnp.stack([crop(px), crop(py), crop(pz)], axis=-1),
        jnp.stack([crop(nx), crop(ny), crop(nz)], axis=-1),
        crop(min_t),
        hit.astype(jnp.float32),
        crop(lo_img),
        crop(hi_img),
        depth_r,
        nodes_n,
        overflow,
    )


@partial(jax.custom_jvp, nondiff_argnums=(0,))
def _shared_gbuffer(statics, scene):
    return _shared_primal(statics, scene)


@_shared_gbuffer.defjvp
def _shared_gbuffer_jvp(statics, primals, tangents):
    """Tangents re-derived from the saved path codes (the same
    straight-through selection gradient as `ops.binned.binned_gbuffer`,
    full-frame and replicated — sharded backward stays on
    `fit_step_sharded`'s per-block path)."""
    cfg, _mesh = statics
    (scene,) = primals
    (d_scene,) = tangents
    outs = _shared_primal(statics, scene)
    lo_img, hi_img = outs[4], outs[5]
    lo = lo_img.reshape(-1)
    hi = hi_img.reshape(-1)

    from sphereflake.camera import corner_rays
    from sphereflake.models.sphereflake import child_templates, root_frame
    from sphereflake.ops.intersect import safe_sqrt
    from sphereflake.ops.codes import resolve_codes_soa

    h, w = cfg.height, cfg.width

    def f(scene):
        origin, tl, tr, bl = corner_rays(scene.camera, w / h)
        ex, ey = tr - tl, bl - tl
        u = jnp.arange(w, dtype=jnp.float32)[None, :] / w
        v = jnp.arange(h, dtype=jnp.float32)[:, None] / h
        comps = [(tl[a] + (ex[a] * u + ey[a] * v)) - origin[a]
                 for a in range(3)]
        dnorm = jnp.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
        dx, dy, dz = ((c / dnorm).reshape(-1) for c in comps)
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        min_t, cx, cy, cz, hitb = resolve_codes_soa(
            dx, dy, dz, lo, root, templates, scene.fractal, cfg,
            code_hi_f=hi if cfg.max_depth >= 7 else None,
        )
        t0 = jnp.where(hitb, min_t, 0.0)
        px, py, pz = dx * t0, dy * t0, dz * t0
        wx, wy, wz = px - cx, py - cy, pz - cz
        nn = safe_sqrt(wx * wx + wy * wy + wz * wz)
        nn = jnp.where(nn > 0, nn, 1.0)
        hf = hitb.astype(jnp.float32)
        img = lambda a: a.reshape(h, w)
        return (
            jnp.stack([img(px), img(py), img(pz)], axis=-1),
            jnp.stack(
                [img(hf * (wx / nn)), img(hf * (wy / nn)),
                 img(hf * (wz / nn))],
                axis=-1,
            ),
            img(min_t),
        )

    _, d3 = jax.jvp(f, (scene,), (d_scene,))
    zeros = tuple(jnp.zeros_like(o) for o in outs[3:])
    return outs, d3 + zeros


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_gbuffer_shared(scene: SceneParams, cfg: RenderConfig, mesh: Mesh):
    """Full-frame G-buffer via the shared-bin pipeline (see module
    docstring); output equals single-device `render_gbuffer` bit-for-
    bit. Returns a `render.GBuffer`."""
    from sphereflake.render import GBuffer, RenderMetrics

    (pos, nrm, min_t, hit_f, _lo, _hi, depth_r, nodes_n, overflow) = (
        _shared_gbuffer((cfg, mesh), scene)
    )
    hit = hit_f > 0.5
    metrics = RenderMetrics(
        max_depth_reached=depth_r.astype(jnp.int32),
        nodes_visited=nodes_n.astype(jnp.int32),
        overflow=overflow.astype(jnp.int32),
        closest_distance=jnp.min(min_t),
        rays_traced=jnp.int32(cfg.width * cfg.height),
    )
    return GBuffer(
        position=pos, normal=nrm, min_t=min_t, hit=hit, metrics=metrics
    )
