"""Full-frame G-buffer rendering: camera -> tiles -> traversal.

This replaces the reference's worker-thread loop
(`Sphereflake.cpp:86-214`): instead of threads statistically sharding
the pixel stream, the image is cut into static screen tiles (the
"packets" of this build). The binned path (`ops/binned.py`) traces
every tile in one kernel launch; the XLA paths (`ops/traversal.py`)
trace tiles in batches (lax.map) to bound the live [rays x frontier]
working set.

The output is the reference's G-buffer (`Sphereflake.h:7-11`): a
position plane and a normal plane (camera-relative positions, unit
normals, zeros for sky), plus the reference's live metrics
(`Sphereflake.h:30-58`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from sphereflake.camera import pixel_grid, ray_directions
from sphereflake.config import RenderConfig, SceneParams
from sphereflake.models.sphereflake import child_templates, root_frame
from sphereflake.ops.traversal import (
    TraceResult,
    _BIG,
    shade_gbuffer,
    tile_tracer,
)

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RenderMetrics:
    """The reference's title-bar counters (`main.cpp:271-294`), computed
    as reductions instead of racy shared fields."""

    max_depth_reached: Array  # [] int32
    nodes_visited: Array  # [] int32 — frontier slots tested
    overflow: Array  # [] int32 — nodes dropped at frontier capacity
    closest_distance: Array  # [] f32 — min over rays of hit t (drives SSAO radius)
    rays_traced: Array  # [] int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GBuffer:
    position: Array  # [H, W, 3] camera-relative hit positions (dir * t)
    normal: Array  # [H, W, 3] unit normals, zeros at sky
    min_t: Array  # [H, W] hit distance, _BIG at sky
    hit: Array  # [H, W] bool
    metrics: RenderMetrics


def _tile(img: Array, cfg: RenderConfig) -> Array:
    """[pH, pW, ...] -> [T, R, ...] row-major over (tile_y, tile_x).

    Operates on the padded image (the binned path pads to a tile
    multiple; for the XLA paths padded == original)."""
    rest = img.shape[2:]
    x = img.reshape(cfg.tiles_y, cfg.tile_h, cfg.tiles_x, cfg.tile_w, *rest)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape(cfg.tiles_y * cfg.tiles_x, cfg.tile_h * cfg.tile_w, *rest)


def _untile(tiles: Array, cfg: RenderConfig) -> Array:
    """[T, R, ...] -> [H, W, ...] inverse of `_tile` (crops padding)."""
    rest = tiles.shape[2:]
    x = tiles.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_h, cfg.tile_w, *rest)
    x = jnp.moveaxis(x, 2, 1)
    x = x.reshape(cfg.padded_height, cfg.padded_width, *rest)
    return x[: cfg.height, : cfg.width]


def grow_capacity(cfg: RenderConfig) -> RenderConfig:
    """Next config in the capacity ladder after an overflow (capacity
    may cost speed, never correctness — the reference's recursion
    visits every LOD-passing node, `Sphereflake.h:165-172`).

    Binned path: double global_cap until every level-5 parent fits the
    expansion gate cap (ecap = global_cap/9 >= 59049), then halve the
    band height — banding slices the live set per band, which bounds
    capacity at ANY pose. Per-tile paths: double max_frontier."""
    if cfg.algorithm != "binned":
        return dataclasses.replace(cfg, max_frontier=cfg.max_frontier * 2)
    if cfg.global_cap < (9 << 16):
        return dataclasses.replace(cfg, global_cap=cfg.global_cap * 2)
    rows = cfg.effective_band_rows or cfg.tiles_y
    new_rows = max(1, rows // 4)
    while new_rows > 1 and cfg.tiles_y % new_rows:
        new_rows -= 1
    if (cfg.effective_band_rows or cfg.tiles_y) == new_rows:
        raise RuntimeError(
            "capacity ladder exhausted (1-tile-row bands still overflow)"
        )
    return dataclasses.replace(cfg, band_tile_rows=new_rows)


@partial(jax.jit, static_argnames=("cfg",))
def render_frame(scene: SceneParams, cfg: RenderConfig):
    """The complete pipeline of the reference app's `Render()`
    (`main.cpp:301-335`): trace -> SSAO -> blur x2 -> composite, one fused
    device program. Returns (image [H, W, 3], GBuffer)."""
    from sphereflake.ops.noise import ssao_noise_texture
    from sphereflake.ops.post import postprocess

    gb = render_gbuffer(scene, cfg)
    noise = jnp.asarray(ssao_noise_texture(cfg.noise_size))
    image = postprocess(
        gb.position, gb.normal, gb.metrics.closest_distance, scene, cfg, noise
    )
    return image, gb


def trace_tiles(
    tiles: Array,  # [T, R, 3] unit ray dirs
    tile_planes: Array,  # [T, 4, 3] frustum planes
    scene: SceneParams,
    cfg: RenderConfig,
    frame=None,  # (frame_w, frame_h, x_off, y_off): sharded block origin
) -> TraceResult:
    """Trace a batch of ray tiles — the unified dispatch over all
    per-tile XLA traversals (`cfg.algorithm`), batched over tiles.
    Differentiable on every path."""
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)

    assert cfg.algorithm != "binned", (
        "the binned path renders whole blocks (raygen is fused into "
        "the kernel) — use render_gbuffer / _render_gbuffer_binned"
    )
    tracer = tile_tracer(cfg)

    def trace_one(tile_dirs):
        return tracer(tile_dirs, root, templates, scene.fractal, cfg)

    n_tiles = tiles.shape[0]
    batch = max(1, min(cfg.tile_batch, n_tiles))
    if n_tiles % batch == 0 and n_tiles > batch:
        res = jax.lax.map(jax.vmap(trace_one), tiles.reshape(
            n_tiles // batch, batch, *tiles.shape[1:]
        ))
        res = jax.tree.map(lambda x: x.reshape(n_tiles, *x.shape[2:]), res)
    else:
        res = jax.vmap(trace_one)(tiles)
    return TraceResult(
        min_t=res.min_t,
        center=res.center,
        hit=res.hit,
        max_depth_reached=jnp.max(res.max_depth_reached),
        nodes_visited=jnp.sum(res.nodes_visited),
        overflow=jnp.sum(res.overflow),
    )


def _untile_rows(out: Array, cfg: RenderConfig) -> list:
    """[T, C, TILE_RAYS] kernel rows -> list of C [H, W] images, one
    `_untile` transpose per row, so XLA can drop the rows a consumer
    never reads."""
    return [_untile(out[:, c], cfg) for c in range(out.shape[1])]


def _binned_rows(scene: SceneParams, cfg: RenderConfig, frame):
    """Shaded kernel rows [T, 7, TILE_RAYS] (min_t, pos3, nrm3) for
    cfg's full tile grid, plus (depth_reached, nodes_visited, overflow).

    `frame` = (frame_w, frame_h, x_off, y_off): cfg may describe one
    device's block of a larger sharded frame. When
    `cfg.effective_band_rows` is set (explicitly, or automatically for
    tile counts that would blow the pair budget — the 16384^2 enabler,
    `/root/reference/README.md:51`), the grid renders in horizontal
    bands inside a lax.map; bands COMPOSE with sharding because each
    band is just a further y-offset block of the same frame (round-3
    verdict item 4)."""
    from sphereflake.ops.binned import binned_gbuffer
    from sphereflake.ops.codes import TILE_RAYS, depth_reached_soa

    fw, fh, x0, y0 = frame
    x0 = jnp.asarray(x0, jnp.float32)
    y0 = jnp.asarray(y0, jnp.float32)

    def one(c, y_off):
        (min_t, px, py, pz, nx, ny, nz, _hitf, lo, hi, nodes, povf) = (
            binned_gbuffer((c, fw, fh), scene, (x0, y_off))
        )
        Tb = c.tiles_y * c.tiles_x
        rows = jnp.stack(
            [r.reshape(Tb, TILE_RAYS) for r in (min_t, px, py, pz, nx, ny, nz)],
            axis=1,
        )
        return (
            rows,
            depth_reached_soa(lo, c, hi),
            nodes.astype(jnp.int32),
            povf.astype(jnp.int32),
        )

    band_rows = cfg.effective_band_rows
    if band_rows is None:
        rows, depth_r, nodes_n, ovf = one(cfg, y0)
        return rows, (depth_r, nodes_n, ovf)

    band_px = band_rows * cfg.tile_h
    n_bands = cfg.tiles_y // band_rows
    bcfg = dataclasses.replace(
        cfg, height=band_px, band_tile_rows=None, width=cfg.padded_width
    )
    Tb = bcfg.tiles_y * bcfg.tiles_x

    def band(b):
        return one(bcfg, y0 + (b * band_px).astype(jnp.float32))

    rows_b, depth_b, nodes_b, ovf_b = jax.lax.map(band, jnp.arange(n_bands))
    return (
        rows_b.reshape(n_bands * Tb, 7, TILE_RAYS),
        (jnp.max(depth_b), jnp.sum(nodes_b), jnp.sum(ovf_b)),
    )


def _render_gbuffer_binned(scene: SceneParams, cfg: RenderConfig) -> GBuffer:
    """The production pipeline: ONE trace-kernel launch computes
    raygen + binned ray tests + G-buffer shading (`binned_gbuffer`);
    XLA's remaining jobs are the node binning and the tile->image
    untiles (banding handled inside `_binned_rows`)."""
    rows, (depth_r, nodes_n, overflow) = _binned_rows(
        scene, cfg, (cfg.width, cfg.height, 0.0, 0.0)
    )
    imgs = _untile_rows(rows, cfg)
    min_t_img = imgs[0]
    hit_img = min_t_img < _BIG
    metrics = RenderMetrics(
        max_depth_reached=depth_r,
        nodes_visited=nodes_n,
        overflow=overflow,
        closest_distance=jnp.min(min_t_img),
        rays_traced=jnp.int32(cfg.width * cfg.height),
    )
    return GBuffer(
        position=jnp.stack(imgs[1:4], axis=-1),
        normal=jnp.stack(imgs[4:7], axis=-1),
        min_t=min_t_img,
        hit=hit_img,
        metrics=metrics,
    )


@partial(jax.jit, static_argnames=("cfg",))
def render_gbuffer(scene: SceneParams, cfg: RenderConfig) -> GBuffer:
    """Render the full-frame G-buffer for `scene` (pure, differentiable)."""
    if cfg.algorithm == "binned":
        return _render_gbuffer_binned(scene, cfg)

    from sphereflake.camera import tile_frustum_planes

    # Ray math uses the ORIGINAL width/height for the NDC mapping; the
    # grid extends to the padded dims (extra rows/cols extrapolate the
    # corner interpolation and are cropped by `_untile`).
    xs, ys = pixel_grid(cfg.padded_width, cfg.padded_height)
    dirs = ray_directions(scene.camera, xs, ys, cfg.width, cfg.height)

    tiles = _tile(dirs, cfg)  # [T, R, 3]
    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )

    res = trace_tiles(tiles, planes, scene, cfg)
    position_t, normal_t = shade_gbuffer(tiles, res)

    min_t = _untile(res.min_t, cfg)
    hit = _untile(res.hit, cfg)
    metrics = RenderMetrics(
        max_depth_reached=res.max_depth_reached,
        nodes_visited=res.nodes_visited,
        overflow=res.overflow,
        closest_distance=jnp.min(jnp.where(hit, min_t, _BIG)),
        rays_traced=jnp.int32(cfg.width * cfg.height),
    )
    return GBuffer(
        position=_untile(position_t, cfg),
        normal=_untile(normal_t, cfg),
        min_t=min_t,
        hit=hit,
        metrics=metrics,
    )
