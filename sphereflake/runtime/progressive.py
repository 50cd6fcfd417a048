"""Frameless progressive rendering — the reference's defining feature.

The reference's worker threads loop forever, each iteration drawing one
Sobol-distributed pixel, tracing a packet around it, and scattering the
result into the shared G-buffer with no frame barrier
(`Sphereflake.cpp:86-214`, `README.md:10`). The display thread snapshots
whatever is in the buffer at vsync.

Two equivalents, both pure step functions:

- **Tile-granular** (`progressive_tiles_step`, the production mode):
  the refresh unit is a whole 1024-ray tile — this build's packet, as
  the reference's is 8 AVX lanes. Sobol chooses TILES; each step
  traces them through the same trace kernel as full frames and
  overwrites their rows densely.
- **Sample-granular** (`progressive_step`, reference semantics): Sobol
  chooses PIXELS; batches are tile-sorted into 1024-ray bundles,
  traced over conservative pair-segment spans, and scattered per
  pixel. It exists for parity with the reference's exact sampling
  law; each sample also pays a sort and a scatter.

The display analogue is simply reading the state's arrays between
steps — double-buffering falls out of JAX's async dispatch (the next
step's computation overlaps the host consuming the previous snapshot).

Determinism: the reference scrambles every sample with a fresh
`mt19937` draw seeded by `time(NULL)` (`Sphereflake.cpp:88-90,139-141`),
which randomizes away both reproducibility *and* the low-discrepancy
structure. Here each step derives its scrambles from a fold of the
user-provided seed and the step counter — reproducible, and with
`scramble="fixed"` the Sobol stream keeps its stratification (the
quality-improving default; `scramble="per_sample"` mimics the
reference's white-noise behavior).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from sphereflake.camera import ray_directions
from sphereflake.config import RenderConfig, SceneParams
from sphereflake.models.sphereflake import child_templates, root_frame
from sphereflake.ops.codes import TILE_RAYS
from sphereflake.ops.sobol import sobol_sample
from sphereflake.ops.traversal import _BIG, shade_gbuffer, tile_tracer

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ProgressiveState:
    """Persistent frameless G-buffer + sample-stream cursor."""

    position: Array  # [H, W, 3]
    normal: Array  # [H, W, 3]
    min_t: Array  # [H, W]
    sample_lo: Array  # [] uint32 — global Sobol index cursor (low word)
    sample_hi: Array  # [] uint32 — high word (52-bit stream like the ref)
    seed: Array  # [] uint32 — scramble stream seed
    closest_distance: Array  # [] f32, resettable like the reference metric
    samples_traced: Array  # [] uint32
    overflow: Array  # [] int32 — accumulated pair/frontier drops (never silent)


def progressive_init(cfg: RenderConfig, seed: int = 0) -> ProgressiveState:
    h, w = cfg.height, cfg.width
    return ProgressiveState(
        position=jnp.zeros((h, w, 3), jnp.float32),
        normal=jnp.zeros((h, w, 3), jnp.float32),
        min_t=jnp.full((h, w), _BIG, jnp.float32),
        sample_lo=jnp.uint32(0),
        sample_hi=jnp.uint32(0),
        seed=jnp.uint32(seed),
        closest_distance=jnp.float32(_BIG),
        samples_traced=jnp.uint32(0),
        overflow=jnp.int32(0),
    )


def _hash_u32(x: Array) -> Array:
    """Stateless integer hash (PCG-ish mix) for per-sample scrambles."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


@partial(jax.jit, static_argnames=("cfg",))
def progressive_prepare(scene: SceneParams, cfg: RenderConfig):
    """Bin the frame ONCE for a camera/fractal pose, for reuse across
    progressive steps (`progressive_step(..., prepared=...)`).

    The bin stage costs far more than one batch's kernel work, so it
    does not belong inside every step. The pair table depends only on
    (scene, cfg) — exactly the
    state the reference's workers reread each iteration
    (`Sphereflake.cpp:155-173`) — so the caller re-prepares when the
    camera moves, and steps stay pure.
    Returns (pairs, starts, lens, pair_overflow)."""
    from sphereflake.ops.binned import binned_pairs

    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    pairs, t_starts, t_lens, (_n, pair_ovf) = binned_pairs(
        scene, cfg, root, templates
    )
    return pairs, t_starts, t_lens, pair_ovf


def grow_frameless_capacity(cfg: RenderConfig) -> RenderConfig:
    """One rung of the FRAMELESS capacity ladder: double global_cap.

    The full-frame ladder (`render.grow_capacity`) falls back to
    BANDING past the global_cap ceiling, but banding cannot help the
    frameless path — its prepared pair table spans the whole frame —
    so this ladder ends with a clean error instead of spinning through
    futile re-prepares (each a full bin + compile) on band settings
    the prepare ignores. Drivers: `cli.py --progressive` and
    `runtime.animate.frameless_animate`."""
    if cfg.global_cap >= (9 << 16):
        raise RuntimeError(
            "frameless pair table overflows at the capacity ceiling; "
            "render this pose full-frame (banded) instead"
        )
    return dataclasses.replace(cfg, global_cap=cfg.global_cap * 2)


@partial(jax.jit, static_argnames=("cfg",))
def progressive_prepare_trimmed(scene: SceneParams, cfg: RenderConfig):
    """`progressive_prepare` + occlusion trim: renders the frame once
    through the trace kernel, then drops every (node, tile) pair that
    PROVABLY cannot win any pixel of its tile — node's closest possible
    hit distance exceeds the tile's farthest winner.

    Output-preserving by construction: a self-hit on a sphere at
    center c, radius r has t >= |c| - r exactly, and numerically-fuzzy
    tangent grazes stay within the same whole-r margin the 2r binning
    radius provides (`bin_nodes`), so the bound used here is
    t_lo = |c| - 2r - eps. A pair with
    t_lo > max(min_t over the tile) can never beat the incumbent
    winner at any pixel (sky pixels hold min_t = BIG, so any tile
    containing sky keeps all its candidates). A second, exact
    sphere-vs-tile-frustum cull drops bbox-corner phantoms the interval
    binning admits. Static-camera refresh re-traces the same view
    continuously (the reference's operating mode, `README.md:8-10`),
    so the one-time trim cost is amortized across the whole
    accumulation while every remaining step tests fewer candidates.
    Parity with the full renderer is pinned by tests and gated in
    bench.py and chip_smoke.py.

    Returns (pairs, starts, lens, pair_overflow) — drop-in for the
    `prepared` argument of the step functions."""
    from sphereflake.ops.binned import (
        _BIG as BIGF,
        camera_vector,
        trace_pairs,
    )

    pairs, starts, lens, pair_ovf = progressive_prepare(scene, cfg)
    cam = camera_vector(scene, cfg)
    out = trace_pairs(pairs, starts, lens, cfg, cam=cam)
    T = cfg.tiles_y * cfg.tiles_x
    t_max = jnp.max(out[:, 0], axis=1)  # BIG if any sky

    cap = pairs.shape[1]
    iota = jnp.arange(cap, dtype=jnp.int32)
    bounds = jnp.concatenate([starts, (starts[-1] + lens[-1])[None]])
    tile_of = jnp.clip(
        jnp.searchsorted(bounds, iota, side="right") - 1, 0, T
    )
    tile_c = jnp.minimum(tile_of, T - 1)
    in_seg = iota < bounds[-1]
    # Fat-rows payload: rc = r^2 - |c|^2 at row 3, rc4 = 4r^2 - |c|^2
    # at the last row; recover |c| and rad = 2r (f32 round-off here is
    # dwarfed by the whole-r margins below).
    rc, rc4 = pairs[3], pairs[-1]
    cc = jnp.maximum((rc4 - 4.0 * rc) / 3.0, 0.0)
    r2 = jnp.maximum((rc4 - rc) / 3.0, 0.0)
    rad = 2.0 * jnp.sqrt(r2)
    # Occlusion bound: exact minimum self-hit distance is |c| - r; keep
    # the same whole-r fuzz margin the 2r binning radius provides
    # (bin_nodes), i.e. t_lo = |c| - 2r.
    t_lo = jnp.sqrt(cc) - rad - 1e-3
    keep = in_seg & (t_lo <= t_max[tile_c])
    # Exact sphere-vs-tile-frustum cull: binning's interval arithmetic
    # admits bbox-corner pairs whose 2r sphere never meets the tile's
    # ray cone. A tile ray that registers a (fuzzy) self-hit has a
    # point within 2r of the center, so planes-distance < -2r proves no
    # hit — same bounding radius the per-tile kernel's frustum cull
    # uses. These gathers run once per camera.
    from sphereflake.camera import tile_frustum_planes

    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height, cfg.tile_h, cfg.tile_w,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )  # [T, 4, 3] unit inward normals
    pp = planes[tile_c]  # [cap, 4, 3]
    cx, cy, cz = pairs[0], pairs[1], pairs[2]
    dmin = jnp.min(
        pp[:, :, 0] * cx[:, None]
        + pp[:, :, 1] * cy[:, None]
        + pp[:, :, 2] * cz[:, None],
        axis=1,
    )
    keep = keep & (dmin >= -(rad + 1e-3))
    new_tile = jnp.where(keep, tile_of, T)

    order_key = new_tile  # stable sort keeps per-tile pair order
    _, idx = jax.lax.sort(
        (order_key, iota), num_keys=1, is_stable=True
    )
    pairs2 = pairs[:, idx]
    key_sorted = order_key[idx]
    dead = key_sorted >= T
    pairs2 = pairs2.at[3, :].set(jnp.where(dead, -BIGF, pairs2[3, :]))
    bounds2 = jnp.searchsorted(
        key_sorted, jnp.arange(T + 1, dtype=jnp.int32)
    )
    starts2 = bounds2[:-1].astype(jnp.int32)
    lens2 = (bounds2[1:] - bounds2[:-1]).astype(jnp.int32)
    return pairs2, starts2, lens2, pair_ovf


def sample_pixels(state: ProgressiveState, cfg: RenderConfig,
                  batch_size: int, scramble: str = "fixed"):
    """The next `batch_size` Sobol sample pixels of `state`'s stream:
    (px, py) [B] f32 integer pixel coordinates and the 64-bit sample
    indices (idx_lo, idx_hi) [B]."""
    lane = jnp.arange(batch_size, dtype=jnp.uint32)
    idx_lo = state.sample_lo + lane
    carry = (idx_lo < state.sample_lo).astype(jnp.uint32)  # wrap detect
    idx_hi = state.sample_hi + carry

    if scramble == "per_sample":
        scr0 = _hash_u32(idx_lo ^ state.seed)
        scr1 = _hash_u32(idx_lo ^ state.seed ^ jnp.uint32(0x9E3779B9))
    else:  # fixed per-stream scramble: keeps the (0,2)-sequence structure
        scr0 = jnp.broadcast_to(_hash_u32(state.seed), lane.shape)
        scr1 = jnp.broadcast_to(
            _hash_u32(state.seed ^ jnp.uint32(0x9E3779B9)), lane.shape
        )

    # Pixel selection mirrors `Sphereflake.cpp:139-141`:
    # x = 1 + floor(sobol0 * (W-2)), y likewise (AVX path).
    sx = sobol_sample(idx_lo, 0, scr0, idx_hi)
    sy = sobol_sample(idx_lo, 1, scr1, idx_hi)
    px = 1.0 + jnp.floor(sx * (cfg.width - 2))
    py = 1.0 + jnp.floor(sy * (cfg.height - 2))
    return px, py, idx_lo, idx_hi


def sample_bundles(scene: SceneParams, cfg: RenderConfig, px, py,
                   starts, lens):
    """Group sample pixels (px, py) [B] into 1024-ray bundles for the
    trace kernel's ray-input variant: returns (order [B] — bundle slot
    to sample —, dirs [B/1024, 3, TILE_RAYS], b_start, b_len).

    Sobol samples are scattered across the screen, so the batch is
    sorted by tile first (samples of nearby tiles land in the same
    bundle). Each bundle gets the contiguous pair-segment SPAN of the
    tiles it touches (tile segments are adjacent in tile order, so the
    union of tiles [t_lo, t_hi] is pairs[starts[t_lo] : starts[t_hi] +
    lens[t_hi]]) — a conservative superset; the per-ray tests are
    exact, and the kernel's loop takes spans of any length."""
    from sphereflake.ops.binned import _camera_rays, camera_vector

    if px.shape[0] % TILE_RAYS:
        raise ValueError(
            f"binned progressive needs batch_size % {TILE_RAYS} == 0"
        )
    xi, yi = px.astype(jnp.int32), py.astype(jnp.int32)
    tile_id = (yi // cfg.tile_h) * cfg.tiles_x + xi // cfg.tile_w
    # Each sample's ray uses the full frame's in-kernel raygen formula
    # for that pixel (its tile and lane): f32 hits on deep, small
    # spheres amplify any other rounding of the direction.
    lane = (yi % cfg.tile_h) * cfg.tile_w + xi % cfg.tile_w
    dirs = jnp.stack(
        _camera_rays(camera_vector(scene, cfg), tile_id, lane, cfg),
        axis=-1,
    )
    order = jnp.argsort(tile_id, stable=True)
    groups = dirs[order].reshape(-1, TILE_RAYS, 3)
    tid_sorted = tile_id[order].reshape(-1, TILE_RAYS)
    t_lo, t_hi = tid_sorted[:, 0], tid_sorted[:, -1]
    b_start = jnp.take(starts, t_lo)
    b_len = jnp.take(starts, t_hi) + jnp.take(lens, t_hi) - b_start
    return order, jnp.swapaxes(groups, 1, 2), b_start, b_len


@partial(jax.jit, static_argnames=("cfg", "batch_size", "scramble"))
def progressive_step(
    state: ProgressiveState,
    scene: SceneParams,
    cfg: RenderConfig,
    batch_size: int = 16384,
    scramble: str = "fixed",
    prepared=None,
) -> ProgressiveState:
    """Trace one batch of Sobol samples and scatter into the G-buffer.

    `prepared` (binned path): the cached `progressive_prepare` pair
    table; without it every step re-bins the whole frame."""
    h, w = cfg.height, cfg.width
    px, py, idx_lo, idx_hi = sample_pixels(state, cfg, batch_size, scramble)
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)

    if cfg.algorithm == "binned":
        from sphereflake.ops.binned import binned_pairs, trace_pairs

        if prepared is not None:
            pairs, t_starts, t_lens, pair_ovf = prepared
        else:
            pairs, t_starts, t_lens, (_n, pair_ovf) = binned_pairs(
                scene, cfg, root, templates
            )
        order, dirs, b_start, b_len = sample_bundles(
            scene, cfg, px, py, t_starts, t_lens
        )
        out = trace_pairs(pairs, b_start, b_len, cfg, dirs=dirs)
        inv = jnp.argsort(order, stable=True)
        unsort = lambda rows: jnp.moveaxis(rows, 1, -1).reshape(
            batch_size, -1
        )[inv]
        min_t = out[:, 0].reshape(-1)[inv]
        pos = unsort(out[:, -6:-3])
        nrm = unsort(out[:, -3:])
        hit = min_t < _BIG
        overflow = pair_ovf
    else:
        dirs = ray_directions(scene.camera, px, py, w, h)  # [B, 3]
        res = tile_tracer(cfg)(dirs, root, templates, scene.fractal, cfg)
        pos, nrm = shade_gbuffer(dirs, res)
        min_t, hit, overflow = res.min_t, res.hit, res.overflow

    xi = px.astype(jnp.int32)
    yi = py.astype(jnp.int32)
    # Deterministic duplicate resolution: the reference's racy G-buffer
    # lets whichever thread writes last win (`Sphereflake.cpp:186-201`);
    # here duplicates within a batch resolve to the LAST sample in
    # batch order, made explicit by scattering only each pixel's final
    # winner (unique indices -> well-defined scatter).
    pix = yi * w + xi
    s_order = jnp.argsort(pix, stable=True)
    pix_s = pix[s_order]
    is_winner = jnp.concatenate(
        [pix_s[:-1] != pix_s[1:], jnp.ones((1,), bool)]
    )
    dst = jnp.where(is_winner, pix_s, w * h)  # losers -> dump slot

    def scatter_plane(plane, updates):
        flat = plane.reshape(w * h, *updates.shape[1:])
        pad = jnp.zeros((1, *updates.shape[1:]), flat.dtype)
        out = jnp.concatenate([flat, pad], axis=0)
        out = out.at[dst].set(updates[s_order])
        return out[: w * h].reshape(plane.shape)

    position = scatter_plane(state.position, pos)
    normal = scatter_plane(state.normal, nrm)
    min_t_plane = scatter_plane(state.min_t, min_t)

    batch_closest = jnp.min(jnp.where(hit, min_t, _BIG))
    return ProgressiveState(
        position=position,
        normal=normal,
        min_t=min_t_plane,
        # 64-bit cursor advance: +1 past the last index, carrying into
        # the hi word when lo wraps (power-of-two batch sizes land the
        # cursor exactly on the 2^32 boundary, where dropping the carry
        # would restart the Sobol stream — a ~70-minute horizon at
        # 1G rays/s).
        sample_lo=idx_lo[-1] + jnp.uint32(1),
        sample_hi=idx_hi[-1]
        + (idx_lo[-1] + jnp.uint32(1) == 0).astype(jnp.uint32),
        seed=state.seed,
        closest_distance=jnp.minimum(state.closest_distance, batch_closest),
        samples_traced=state.samples_traced + jnp.uint32(batch_size),
        overflow=state.overflow + jnp.asarray(overflow, jnp.int32),
    )


def reset_closest_distance(state: ProgressiveState) -> ProgressiveState:
    """`Sphereflake::ResetClosestSphereDistance` (`Sphereflake.h:55-58`)."""
    return dataclasses.replace(state, closest_distance=jnp.float32(_BIG))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TileProgressiveState:
    """Frameless accumulation at TILE granularity. The reference's
    workers refresh 8-pixel AVX packets chosen by a Sobol stream
    (`Sphereflake.cpp:139-150`); this build's packet is a 1024-ray
    tile, so the frameless unit becomes a tile: each step traces a
    Sobol-chosen batch of whole tiles through the SAME trace kernel as
    full frames (raygen + trace + shade in one launch) and overwrites
    those tiles' rows in place — dense block writes instead of
    per-pixel scatters."""

    rows: Array  # [T, 7, TILE_RAYS] shaded kernel rows (min_t, pos3, nrm3)
    covered: Array  # [T] bool — tile refreshed at least once
    sample_lo: Array  # [] uint32 Sobol cursor
    sample_hi: Array
    seed: Array
    closest_distance: Array
    samples_traced: Array
    overflow: Array  # [] int32 — pair-table/kernel drops, accumulated
    # per step (the project invariant: overflow is counted, never
    # silent — the CLI retries via the capacity ladder on it, like the
    # full-frame path)


def progressive_tiles_init(
    cfg: RenderConfig, seed: int = 0
) -> TileProgressiveState:
    T = cfg.tiles_y * cfg.tiles_x
    rows = jnp.zeros((T, 7, TILE_RAYS), jnp.float32)
    rows = rows.at[:, 0].set(_BIG)  # min_t row: sky until traced
    return TileProgressiveState(
        rows=rows,
        covered=jnp.zeros((T,), bool),
        sample_lo=jnp.uint32(0),
        sample_hi=jnp.uint32(0),
        seed=jnp.uint32(seed),
        closest_distance=jnp.float32(_BIG),
        samples_traced=jnp.uint32(0),
        overflow=jnp.int32(0),
    )


@partial(jax.jit, static_argnames=("cfg", "tiles_per_step"))
def progressive_tiles_step(
    state: TileProgressiveState,
    scene: SceneParams,
    cfg: RenderConfig,
    tiles_per_step: int = 128,
    prepared=None,
) -> TileProgressiveState:
    """Trace `tiles_per_step` Sobol-chosen tiles and refresh them.

    `prepared`: cached `progressive_prepare` pair table (static
    camera); without it the frame is re-binned each step."""
    from sphereflake.ops.binned import (
        binned_pairs,
        camera_vector,
        trace_pairs,
    )

    T = cfg.tiles_y * cfg.tiles_x
    lane = jnp.arange(tiles_per_step, dtype=jnp.uint32)
    idx_lo = state.sample_lo + lane
    carry = (idx_lo < state.sample_lo).astype(jnp.uint32)
    idx_hi = state.sample_hi + carry
    scr = jnp.broadcast_to(_hash_u32(state.seed), lane.shape)
    s = sobol_sample(idx_lo, 0, scr, idx_hi)
    ids = jnp.minimum((s * T).astype(jnp.int32), T - 1)

    if prepared is not None:
        pairs, starts, lens, pair_ovf = prepared
    else:
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        pairs, starts, lens, (_n, pair_ovf) = binned_pairs(
            scene, cfg, root, templates
        )
    cam = camera_vector(scene, cfg)
    # shade_only: the state never stores path codes, so the code
    # accumulators leave the kernel's loop and the output rows ARE the
    # state layout (min_t, pos3, nrm3) — no re-pack copy.
    out = trace_pairs(
        pairs, starts, lens, cfg, cam=cam, tile_ids=ids, shade_only=True
    )
    # Duplicate tile ids within a batch write IDENTICAL rows (same
    # camera), so the unordered scatter is deterministic by value.
    rows = state.rows.at[ids].set(out)
    covered = state.covered.at[ids].set(True)
    batch_closest = jnp.min(out[:, 0])
    return TileProgressiveState(
        rows=rows,
        covered=covered,
        # hi-word carry at the 2^32 lo wrap (see ProgressiveState's
        # cursor note).
        sample_lo=idx_lo[-1] + jnp.uint32(1),
        sample_hi=idx_hi[-1]
        + (idx_lo[-1] + jnp.uint32(1) == 0).astype(jnp.uint32),
        seed=state.seed,
        closest_distance=jnp.minimum(
            state.closest_distance, batch_closest
        ),
        samples_traced=state.samples_traced
        + jnp.uint32(tiles_per_step * 1024),
        overflow=state.overflow + jnp.asarray(pair_ovf, jnp.int32),
    )


def tile_progressive_gbuffer(state: TileProgressiveState, cfg: RenderConfig):
    """Snapshot the accumulated tile rows as (position, normal, min_t,
    hit) images — the display read of the frameless loop."""
    from sphereflake.render import _untile_rows

    imgs = _untile_rows(state.rows, cfg)
    min_t = imgs[0]
    hit = min_t < _BIG
    position = jnp.stack(imgs[1:4], axis=-1)
    normal = jnp.stack(imgs[4:7], axis=-1)
    return position, normal, min_t, hit


@partial(jax.jit, static_argnames=("cfg",))
def tile_progressive_composite(
    state: TileProgressiveState,
    scene: SceneParams,
    cfg: RenderConfig,
    noise: Array | None = None,
):
    """SSAO -> blur -> blur -> composite over the IN-FLIGHT frameless
    buffer — the reference's display loop, which every vsync uploads
    whatever the workers have written so far and runs the full post
    chain on it (`main.cpp:301-335`, `SSAO.cpp:106-142`). Tiles never
    refreshed still hold their init rows (sky), exactly as the
    reference's G-buffer shows stale/unwritten texels mid-flight.

    At full coverage the result equals `render_frame(scene, cfg)[0]`
    of the same scene (pinned by tests/test_progressive.py): the
    closest-distance feeding the SSAO radius law (`main.cpp:316`) is
    recomputed from the cropped min_t plane with the full renderer's
    exact formula, not the running metric (which also sees padded
    extrapolation columns).
    """
    from sphereflake.ops.noise import ssao_noise_texture
    from sphereflake.ops.post import postprocess

    position, normal, min_t, _hit = tile_progressive_gbuffer(state, cfg)
    closest = jnp.min(min_t)  # `_render_gbuffer_binned` metric formula
    if noise is None:
        noise = jnp.asarray(ssao_noise_texture(cfg.noise_size))
    return postprocess(position, normal, closest, scene, cfg, noise)
