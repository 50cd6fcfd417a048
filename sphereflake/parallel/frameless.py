"""Mesh-sharded frameless accumulation — all devices refine ONE
frameless buffer, the way all the reference's worker threads share one
G-buffer (`Sphereflake.cpp:67-74`).

The single-device tile-progressive mode (`runtime/progressive.py`)
refreshes Sobol-chosen 1024-ray tiles through the trace kernel. Here
the frame's tile grid is cut into per-device blocks (`P("ty", "tx")`),
and each device refreshes Sobol-chosen tiles OF ITS OWN BLOCK with its
own scramble stream — the reference seeds an independent scrambled
Sobol stream per worker thread the same way (`Sphereflake.cpp:88-90`),
so no two workers coordinate and the buffer converges statistically.
Unlike the reference's racy shared memory, block ownership makes every
write location device-local: the mesh needs NO communication in the
step at all (the scalar metrics are psum/pmin reductions).

The pair table is prepared once per camera (`progressive_prepare`) and
replicated — it is a few MB, and every worker of the reference likewise
rereads the one shared scene. Each refreshed tile runs the IDENTICAL
kernel invocation a single-device run would (same global tile id, same
camera vector, same pair segments), so tile contents are bit-equal to
the single-device mode — pinned by tests/test_sharded.py.
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
from sphereflake.ops.codes import TILE_RAYS
from sphereflake.ops.traversal import _BIG

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedTileState:
    """Frameless G-buffer sharded over a 2D tile-block mesh.

    `rows` is laid out [ty_n, tx_n, 7, TILE_RAYS] (tile-grid-major) so the
    mesh shards it rectangularly; per-device Sobol cursors ride a
    [my, mx] plane sharded the same way."""

    rows: Array  # [ty_n, tx_n, 7, TILE_RAYS] (min_t, pos3, nrm3)
    covered: Array  # [ty_n, tx_n] bool
    sample_lo: Array  # [my, mx] uint32 — per-device Sobol cursor
    sample_hi: Array  # [my, mx] uint32
    seed: Array  # [] uint32
    closest_distance: Array  # [] f32 (replicated reduction)
    samples_traced: Array  # [] uint32
    overflow: Array  # [] int32


def _block_tiles(cfg: RenderConfig, mesh: Mesh) -> tuple[int, int]:
    my, mx = mesh.devices.shape
    if cfg.tiles_y % my or cfg.tiles_x % mx:
        raise ValueError(
            f"tile grid {cfg.tiles_y}x{cfg.tiles_x} does not divide the "
            f"mesh {my}x{mx} (pad the frame or pick another mesh)"
        )
    return cfg.tiles_y // my, cfg.tiles_x // mx


def sharded_tiles_init(
    cfg: RenderConfig, mesh: Mesh, seed: int = 0
) -> ShardedTileState:
    my, mx = mesh.devices.shape
    rows = jnp.zeros((cfg.tiles_y, cfg.tiles_x, 7, TILE_RAYS), jnp.float32)
    rows = rows.at[:, :, 0].set(_BIG)
    return ShardedTileState(
        rows=rows,
        covered=jnp.zeros((cfg.tiles_y, cfg.tiles_x), bool),
        sample_lo=jnp.zeros((my, mx), jnp.uint32),
        sample_hi=jnp.zeros((my, mx), jnp.uint32),
        seed=jnp.uint32(seed),
        closest_distance=jnp.float32(_BIG),
        samples_traced=jnp.uint32(0),
        overflow=jnp.int32(0),
    )


@partial(
    jax.jit, static_argnames=("cfg", "mesh", "tiles_per_device")
)
def sharded_tiles_step(
    state: ShardedTileState,
    scene: SceneParams,
    cfg: RenderConfig,
    mesh: Mesh,
    tiles_per_device: int = 128,
    prepared=None,
) -> ShardedTileState:
    """One frameless step: every device traces `tiles_per_device`
    Sobol-chosen tiles of its own block through the trace kernel and
    overwrites them in its shard of the buffer.

    `prepared` is the cached `progressive_prepare` pair table (static
    camera); without it the frame is re-binned (replicated) each step.
    """
    from sphereflake.models.sphereflake import child_templates, root_frame
    from sphereflake.ops.binned import (
        binned_pairs,
        camera_vector,
        trace_pairs,
    )
    from sphereflake.runtime.progressive import _hash_u32
    from sphereflake.ops.sobol import sobol_sample

    bty, btx = _block_tiles(cfg, mesh)
    if prepared is not None:
        pairs, starts, lens, pair_ovf = prepared
    else:
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        pairs, starts, lens, (_n, pair_ovf) = binned_pairs(
            scene, cfg, root, templates
        )
    cam = camera_vector(scene, cfg)
    tx_n = cfg.tiles_x
    n_local = bty * btx

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("ty", "tx"),  # rows block
            P("ty", "tx"),  # covered block
            P("ty", "tx"),  # sample_lo
            P("ty", "tx"),  # sample_hi
            P(),  # seed
            P(),  # cam
            P(),  # pairs
            P(),  # starts
            P(),  # lens
        ),
        out_specs=(
            P("ty", "tx"),
            P("ty", "tx"),
            P("ty", "tx"),
            P("ty", "tx"),
            P(),
        ),
        check_vma=False,
    )
    def step(rows_blk, cov_blk, lo_blk, hi_blk, seed, cam, pairs,
             starts, lens):
        iy = jax.lax.axis_index("ty")
        ix = jax.lax.axis_index("tx")
        lane = jnp.arange(tiles_per_device, dtype=jnp.uint32)
        idx_lo = lo_blk[0, 0] + lane
        carry = (idx_lo < lo_blk[0, 0]).astype(jnp.uint32)
        idx_hi = hi_blk[0, 0] + carry
        # Per-worker scramble stream (the reference's per-thread
        # mt19937 scramble, made deterministic): fold the device's
        # mesh position into the seed.
        wid = (iy * jnp.int32(mesh.devices.shape[1]) + ix).astype(
            jnp.uint32
        )
        scr = jnp.broadcast_to(
            _hash_u32(seed ^ (wid + jnp.uint32(1))), lane.shape
        )
        s = sobol_sample(idx_lo, 0, scr, idx_hi)
        local = jnp.minimum((s * n_local).astype(jnp.int32), n_local - 1)
        ly = local // btx
        lx = local - ly * btx
        gids = (iy * bty + ly) * tx_n + (ix * btx + lx)
        out = trace_pairs(  # exactly (min_t, pos3, nrm3)
            pairs, starts, lens, cfg, cam=cam, tile_ids=gids,
            shade_only=True,
        )
        flat = rows_blk.reshape(n_local, 7, TILE_RAYS)
        flat = flat.at[local].set(out)
        cov = cov_blk.reshape(n_local).at[local].set(True)
        closest = jnp.min(out[:, 0])
        closest = jax.lax.pmin(jax.lax.pmin(closest, "ty"), "tx")
        return (
            flat.reshape(bty, btx, 7, TILE_RAYS),
            cov.reshape(bty, btx),
            # hi-word carry at the 2^32 lo wrap (power-of-two step
            # sizes land the cursor exactly on the boundary, where a
            # dropped carry would restart the Sobol stream).
            (idx_lo[-1] + jnp.uint32(1)).reshape(1, 1),
            (
                idx_hi[-1]
                + (idx_lo[-1] + jnp.uint32(1) == 0).astype(jnp.uint32)
            ).reshape(1, 1),
            closest,
        )

    rows, covered, lo, hi, closest = step(
        state.rows, state.covered, state.sample_lo, state.sample_hi,
        state.seed, cam, pairs, starts, lens,
    )
    my, mx = mesh.devices.shape
    return ShardedTileState(
        rows=rows,
        covered=covered,
        sample_lo=lo,
        sample_hi=hi,
        seed=state.seed,
        closest_distance=jnp.minimum(state.closest_distance, closest),
        samples_traced=state.samples_traced
        + jnp.uint32(my * mx * tiles_per_device * 1024),
        overflow=state.overflow + jnp.asarray(pair_ovf, jnp.int32),
    )


def sharded_tiles_as_single(state: ShardedTileState):
    """View the sharded state as a single-device
    `TileProgressiveState` (rows re-flattened to [T, 7, TILE_RAYS]) so the
    display reads — `tile_progressive_gbuffer` / `..._composite` — are
    shared verbatim with the single-device mode."""
    from sphereflake.runtime.progressive import TileProgressiveState

    ty_n, tx_n = state.covered.shape
    return TileProgressiveState(
        rows=state.rows.reshape(ty_n * tx_n, 7, TILE_RAYS),
        covered=state.covered.reshape(ty_n * tx_n),
        sample_lo=state.sample_lo[0, 0],
        sample_hi=state.sample_hi[0, 0],
        seed=state.seed,
        closest_distance=state.closest_distance,
        samples_traced=state.samples_traced,
        overflow=state.overflow,
    )
