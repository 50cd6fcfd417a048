"""Binned traversal: frame-global expansion + screen-tile binning (XLA)
feeding ONE trace kernel (raygen + ray tests + shading).

1. **Global expansion** (`expand_global`): dense SoA frontier per level
   (component arrays, masked elementwise math), culled by the
   whole-frame frustum and the conservative LOD bound. This is the
   reference's recursion (`Sphereflake.h:86-226`) with the screen for a
   packet.
2. **Binning** (`bin_nodes`): every live node's bounding sphere (radius
   2r, the reference's bounding test radius) is projected to a
   conservative screen-space tile range by exact interval arithmetic in
   the corner-ray basis (`Sphereflake.cpp:162-167` inverted);
   behind-camera nodes are dropped by a corner-ray dot cull; (node,
   tile) pairs are laid out by a packed-key sort into dense per-tile
   segments of a 7|8-row payload (all node-loop scalars precomputed,
   `node_rows`).
3. **Trace kernel** (`trace_pairs`): one Pallas program per 1024-ray
   tile, compiled through Triton on an NVIDIA GPU. Each program reads
   its own segment (start, len), derives its rays from the 16-scalar
   camera vector (or reads them, for per-sample bundles), loops over
   its candidates keeping each ray's nearest hit in registers, and
   shades the winner to (min_t, position, normal).
   `trace_pairs_reference` is the same trace in plain `jnp`/`lax`: the
   reference the kernel is tested against.

Select with ``RenderConfig(algorithm="binned")``.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sphereflake.backend import kernel_route
from sphereflake.config import FractalParams, RenderConfig
from sphereflake.ops.codes import TILE_RAYS

Array = Any
_BIG = np.float32(3.0e38)

PAIR_CAP = 1 << 20  # upper bound on cfg.pair_cap (20-bit fill packing;
# the remaining 11 bits cover tile grids to 2048 per axis = 64k^2 px)
# Trace-kernel warps per 1024-ray program: 4 measured faster than 2 or
# 8 on an H100 (PERF.md).
_NUM_WARPS = 4


_IMIN = -(2**31)


def _cummax_last(x: Array) -> Array:
    """Inclusive running max along the LAST axis via log-shift maxima
    (log2(n) pad+slice+max passes, each a bandwidth-bound elementwise
    op)."""
    n = x.shape[-1]
    pad_cfg = [(0, 0)] * (x.ndim - 1)
    sh = 1
    while sh < n:
        shifted = jnp.pad(
            x, pad_cfg + [(sh, 0)], constant_values=_IMIN
        )[..., :n]
        x = jnp.maximum(x, shifted)
        sh *= 2
    return x


def _running_max_rows(x: Array) -> Array:
    """Per-row inclusive running max over [K, n] int32: two-level
    decomposition ([K, rows, cols] log-shift cummax along cols +
    a small carry cummax over rows)."""
    k, n = x.shape
    rows = 1 << (max(n.bit_length() - 1, 2) // 2 + 1)
    cols = -(-n // rows)
    pad = rows * cols - n
    imin = jnp.int32(_IMIN)
    x2 = jnp.concatenate(
        [x, jnp.full((k, pad), imin, x.dtype)], axis=1
    ).reshape(k, rows, cols)
    row = _cummax_last(x2)
    carry = _cummax_last(row[:, :, -1])
    carry = jnp.concatenate(
        [jnp.full((k, 1), imin, x.dtype), carry[:, :-1]], axis=1
    )
    out = jnp.maximum(row, carry[:, :, None]).reshape(k, rows * cols)
    return tuple(out[i, :n] for i in range(k))


_POW7 = 9**7  # path-code hi/lo split: lo < 9^7 stays f32-exact
# Depth bound of the two-lane f32 path code: a level-d code (with its
# sentinel) lies in [9^d, 9^(d+1)), so at d = 13 hi = code // 9^7 stays
# below 9^7 = 4,782,969 < 2^24 and both lanes are f32-exact. d = 14
# would put hi in [9^7, 9^8) and 9^8 = 43,046,721 > 2^24 silently
# rounds codes to wrong nodes (round-3 advisor finding). 13 is also the
# physical f32 limit: level-13 spheres have radius 3^-13 ~ 6.3e-7,
# approaching the f32 relative-precision floor (eps ~ 1.2e-7) of the
# center coordinates themselves. The reference's recursion is unbounded
# in principle (`Sphereflake.h:146-153`) but its f32 math hits the same
# wall.
DEEP_MAX_DEPTH = 13


def _expand_cap(cfg: RenderConfig) -> int:
    """Pre-expansion live cap: once a level's children would exceed
    global_cap, the parents are compacted this hard first. global_cap
    defaults to exactly 9x this, so compacted parents' children fill
    the emitted level with NO second (emit-time) compaction sort."""
    return max(4096, cfg.global_cap // 9)


def expand_global(
    root: Array,  # [3, 4]
    templates: Array,  # [9, 3, 4]
    fractal: FractalParams,
    cfg: RenderConfig,
    frame_planes: Array,  # [4, 3] inward unit planes of the whole frame
):
    """Levelwise SoA expansion of the whole LOD-passing tree.

    Levels stay DENSE (masked, no data movement) while their 9^l width
    fits `cfg.global_cap`; wider levels are compacted to the cap's
    CLOSEST live nodes before emission. Two jobs at once: (a) the
    binning stage downstream is index-bound, so feeding it ~73k node
    slots instead of the dense 597k is most of its speed; (b) the
    reference's UNBOUNDED LOD-terminated
    recursion depth (`Sphereflake.h:146-153`) becomes reachable — an
    approach dive to level 13 expands only the live frontier, never
    the 9^13 dense tree.

    Path codes ride two lanes (code = hi * 9^7 + lo) so depths past 7
    stay exact in f32 kernel rows (`DEEP_MAX_DEPTH` = 13).

    Returns (nodes dict with [N] component arrays over all levels
    concatenated — cx, cy, cz, cc, r2, code (lo, int32),
    code_hi (int32), live, rad — and the compaction overflow count).
    """
    assert cfg.max_depth <= DEEP_MAX_DEPTH, (
        f"binned path supports max_depth <= {DEEP_MAX_DEPTH} "
        "(two-lane path-code exactness)"
    )
    depth = cfg.max_depth
    cap = cfg.global_cap
    lod_sq = jnp.float32(cfg.lod_factor**2)
    ratio = fractal.radius_ratio
    radius0 = fractal.root_radius

    rot = [[templates[:, a, b] for b in range(3)] for a in range(3)]  # [9]
    disp = [templates[:, a, 3] for a in range(3)]

    # Level 0: the root frame.
    r = [jnp.broadcast_to(root[a, b], (1,)) for a in range(3) for b in range(3)]
    t = [jnp.broadcast_to(root[a, 3], (1,)) for a in range(3)]
    lo = jnp.ones((1,), jnp.int32)
    hi = jnp.zeros((1,), jnp.int32)
    live = jnp.ones((1,), bool)
    overflow = jnp.int32(0)

    out = {k: [] for k in ("cx", "cy", "cz", "cc", "r2", "code",
                            "code_hi", "live", "rad")}

    def cull(t, live, radius):
        cx, cy, cz = t
        cc = cx * cx + cy * cy + cz * cz
        # Whole-frame frustum + LOD cull (same conservative tests the
        # per-tile kernel applies, with the frame for a frustum).
        lim = lod_sq * radius + 2.0 * radius
        keep = live & (cc < lim * lim)
        for p in range(4):
            d_p = (
                frame_planes[p, 0] * cx
                + frame_planes[p, 1] * cy
                + frame_planes[p, 2] * cz
            )
            keep = keep & (d_p >= -2.0 * radius)
        return keep

    def emit(t, lo, hi, live, radius):
        cx, cy, cz = t
        n = cx.shape[0]
        out["cx"].append(cx)
        out["cy"].append(cy)
        out["cz"].append(cz)
        out["cc"].append(cx * cx + cy * cy + cz * cz)
        out["r2"].append(jnp.full((n,), 1.0, jnp.float32) * (radius * radius))
        out["code"].append(lo)
        out["code_hi"].append(hi)
        out["live"].append(live)
        out["rad"].append(jnp.full((n,), 1.0, jnp.float32) * (2.0 * radius))

    def compact(r, t, lo, hi, live, cap=cap):
        """Sort-and-gather compaction of live nodes to [cap] slots.

        One stable sort by (dead, distance) keys orders the closest
        live nodes first; a 14-row shared-index gather then moves the
        components (codes bitcast through f32). The distance key
        makes the over-cap drop policy LOD-consistent: the FARTHEST
        nodes go, never the near subtree an approach dive exists to
        reveal.
        """
        n = live.shape[0]
        total_all = jnp.sum(live.astype(jnp.int32))
        cc = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
        key = jnp.where(live, cc, _BIG)
        _, idx = jax.lax.sort(
            (key, jnp.arange(n, dtype=jnp.int32)), num_keys=1,
            is_stable=True,
        )
        idx = idx[:cap]
        f32 = jax.lax.bitcast_convert_type
        rows = jnp.stack(
            r + t + [f32(lo, jnp.float32), f32(hi, jnp.float32)]
        )  # [14, n]
        packed = rows[:, idx]  # [14, cap]
        total = jnp.minimum(total_all, cap)
        i32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        new_live = jnp.arange(cap, dtype=jnp.int32) < total
        return (
            [packed[k] for k in range(9)],
            [packed[9 + a] for a in range(3)],
            i32(packed[12]),
            i32(packed[13]),
            new_live,
            jnp.maximum(total_all - cap, 0),
        )

    radius = radius0
    live = cull(t, live, radius)
    emit(t, lo, hi, live, radius)
    ecap = _expand_cap(cfg)
    for _level in range(depth):
        if 9 * live.shape[0] > cap and live.shape[0] > ecap:
            # Children would exceed the cap. Only parents that can
            # produce a LOD-passing child need to survive: a child's
            # emit cull needs |c_child| < lod^2*r_c + 2*r_c, and
            # |c_child| >= |c_parent| - (1+ratio)*r_p, so the gate
            # below is exactly conservative. At the reference pose
            # level 5 is ~59k live but ZERO of them can spawn live
            # level-6 children — this is what keeps the expansion (and
            # its compaction sort) ~9x ecap instead of 9x the dense
            # level width.
            r_c = radius * ratio
            lim = lod_sq * r_c + 2.0 * r_c + (1.0 + ratio) * radius
            cc_cur = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
            gate = live & (cc_cur < lim * lim)
            r, t, lo, hi, live, ovf = compact(r, t, lo, hi, gate, ecap)
            overflow = overflow + ovf
        scale = (1.0 + ratio) * radius
        # Children: [9, N] via broadcasting template constants.
        new_r = [
            sum(r[3 * a + k][None, :] * rot[k][b][:, None] for k in range(3))
            for a in range(3)
            for b in range(3)
        ]
        new_t = [
            sum(r[3 * a + k][None, :] * (scale * disp[k])[:, None]
                for k in range(3))
            + t[a][None, :]
            for a in range(3)
        ]
        j9 = jnp.arange(9, dtype=jnp.int32)[:, None]
        lo9 = lo[None, :] * 9 + j9
        carry = lo9 // _POW7
        lo = lo9 - carry * _POW7
        hi = hi[None, :] * 9 + carry
        n9 = lo.shape[0] * lo.shape[1]
        r = [x.reshape(n9) for x in new_r]
        t = [x.reshape(n9) for x in new_t]
        lo = lo.reshape(n9)
        hi = hi.reshape(n9)
        live = jnp.broadcast_to(live[None, :], (9, live.shape[0])).reshape(n9)
        radius = radius * ratio
        live = cull(t, live, radius)
        # Compact wide levels before emission too, so the binning
        # stage's arrays stay <= global_cap per level.
        if n9 > cap:
            r, t, lo, hi, live, ovf = compact(r, t, lo, hi, live)
            overflow = overflow + ovf
        emit(t, lo, hi, live, radius)

    nodes = {k: jnp.concatenate(v) for k, v in out.items()}
    return nodes, overflow


def corner_basis(cam, width: int, height: int):
    """Rows of M^-1 for the corner-ray basis: a camera-relative point c
    projects to screen uv' = (s0/s2, s1/s2) with s = M^-1 c, where
    M = [TR-TL | BL-TL | TL-origin] (`Sphereflake.cpp:162-167`)."""
    from sphereflake.camera import corner_rays

    origin, tl, tr, bl = corner_rays(cam, width / height)
    m = jnp.stack([tr - tl, bl - tl, tl - origin], axis=1)  # [3, 3]
    minv = jnp.linalg.inv(m)
    return minv


def _decode_tiles_window(geo, cfg: RenderConfig, lo: int, width: int):
    """Decode (tile, node) for pair slots [lo, lo + width) from the
    per-node geometry dict — the windowed heart of the pair fill.

    `bin_nodes` calls this with the full window (lo=0, width=pair_cap);
    the shared-bin sharded path (`parallel/shared_bin.py`) gives each
    device its own static slot window, with the running-max carry-in at
    the window boundary computed DIRECTLY from the node arrays (the
    carry at slot lo is the max packed source over nodes whose first
    slot precedes lo — a masked reduction, exact in int32), so the
    windowed decode is bit-identical to the full one.

    Live nodes have strictly increasing `first`, so in-bounds slots
    are UNIQUE — scatter with mode="drop" + unique_indices, all fill
    sources riding ONE batched scatter. Dead and overflowed nodes aim
    at width + their own index: out of bounds (dropped) but DISTINCT,
    so the uniqueness promise holds for every index (XLA makes
    duplicate indices UB when uniqueness is promised, even dropped
    ones — round-3 advisor finding).
    """
    pair_cap = cfg.pair_cap
    tx_n, ty_n = cfg.tiles_x, cfg.tiles_y
    n_tiles = tx_n * ty_n
    n_nodes = geo["n_nodes"]
    first, counts = geo["first"], geo["counts"]
    tx0, ty0, bw = geo["tx0"], geo["ty0"], geo["bw"]
    n_pairs = geo["n_pairs"]
    iota_n = jnp.arange(n_nodes, dtype=jnp.int32)
    in_table = (counts > 0) & (first < pair_cap)
    # Everything not landing INSIDE this window (dead, overflowed, or
    # out-of-window nodes alike) aims at width + its own index: out of
    # bounds (dropped) but DISTINCT from every in-window slot and from
    # each other, preserving the uniqueness promise.
    in_win = in_table & (first >= lo) & (first < lo + width)
    slot_w = jnp.where(in_win, first - lo, width + iota_n)
    iota_p = lo + jnp.arange(width, dtype=jnp.int32)

    assert pair_cap <= PAIR_CAP
    # Scatter width drives the fill's cost, so pack as tightly as the
    # STATIC bit budgets allow:
    # the fill only needs each packed word monotone over slots, and
    # both `iota_n` (node id) and `first` are strictly increasing —
    # either works as the high-bits carrier.
    nbits = max(1, (n_nodes - 1).bit_length())
    fbits_c = max(1, (pair_cap - 1).bit_length())
    txb = max(1, (tx_n - 1).bit_length())
    tyb = max(1, (ty_n - 1).bit_length())
    bwb = tx_n.bit_length()  # bw in [1, tx_n]
    two_rows = (nbits + bwb <= 31) and (fbits_c + txb + tyb <= 31)
    if two_rows:
        # Row A: (node << bwb) | bw; row B: (first << txb+tyb) |
        # (tx0 << tyb) | ty0 — the whole decode from TWO scans.
        sources = jnp.stack(
            [
                (iota_n << bwb) | bw,
                (first << (txb + tyb)) | (tx0 << tyb) | ty0,
            ]
        )
    else:
        # Fallback (very large grids/caps): one attribute per scan,
        # `first` carrying the monotone high bits of each.
        abits = 31 - fbits_c
        # Strict: a node spanning the full grid width has bw == tx_n,
        # so tx_n itself must fit the pack field — tx_n == 1<<abits
        # would silently clamp that node's width and drop its last tile
        # column (round-4 advisor finding).
        assert tx_n < (1 << abits) and ty_n < (1 << abits), (
            f"tile grid {tx_n}x{ty_n} exceeds the {abits}-bit pack budget"
        )
        amask = (1 << abits) - 1
        sources = jnp.stack(
            [
                iota_n,  # node id
                (first << abits) | tx0,
                (first << abits) | ty0,
                (first << abits) | bw,
            ]
        )
    k = sources.shape[0]
    marks = (
        jnp.full((k, width), -1, jnp.int32)
        .at[:, slot_w]
        .set(sources, mode="drop", unique_indices=True)
    )
    # Boundary carry: the running max entering this window = the max
    # source among nodes scattered before it (int32 max, exact; empty
    # at lo = 0, where the mask is all-False and the max is _IMIN).
    # `lo` may be traced (the shared-bin path passes each device's
    # window start).
    before = in_table & (first < lo)
    carry = jnp.max(jnp.where(before[None, :], sources, _IMIN), axis=1)
    pk = [
        jnp.maximum(r, c)
        for r, c in zip(_running_max_rows(marks), carry)
    ]
    if two_rows:
        pk_a, pk_b = pk
        pair_node = jnp.maximum(pk_a >> bwb, 0)
        nb_w = jnp.maximum(pk_a & ((1 << bwb) - 1), 1)
        p_first = pk_b >> (txb + tyb)
        p_tx0 = (pk_b >> tyb) & ((1 << txb) - 1)
        p_ty0 = pk_b & ((1 << tyb) - 1)
    else:
        pair_node, pk_x0, pk_y0, pk_bw = pk
        pair_node = jnp.maximum(pair_node, 0)
        p_first = pk_x0 >> abits
        p_tx0 = pk_x0 & amask
        p_ty0 = pk_y0 & amask
        nb_w = jnp.maximum(pk_bw & amask, 1)
    pair_rank = iota_p - p_first
    pair_valid = iota_p < n_pairs  # offsets are gapless
    # Overflowed tails can decode garbage coordinates — clip each axis
    # (avoiding i32 overflow in the tile index product) so they land on
    # the sentinel and sort to the end (overflow is counted anyway).
    p_tx = jnp.minimum(p_tx0 + pair_rank % nb_w, tx_n)
    p_ty = jnp.minimum(p_ty0 + pair_rank // nb_w, ty_n)
    tile = jnp.where(
        pair_valid, jnp.minimum(p_ty * tx_n + p_tx, n_tiles), n_tiles
    )
    return tile, pair_node


def _sort_pairs(tile, pair_node, n_nodes: int, n_tiles: int):
    """One sort into tile-segment order. Packed single key (tile <<
    node_bits | node) when both fit 31 bits (halves the sort's data
    movement vs the two-array variadic sort); the argsort-then-gather
    form costs two extra big random gathers for the same result."""
    node_bits = max(1, (n_nodes - 1).bit_length())
    tile_bits = (n_tiles + 1).bit_length()
    if node_bits + tile_bits <= 31:
        packed = (tile << node_bits) | pair_node
        packed = jax.lax.sort(packed)
        tile_sorted = packed >> node_bits
        node_sorted = packed & ((1 << node_bits) - 1)
    else:
        tile_sorted, node_sorted = jax.lax.sort(
            (tile, pair_node), num_keys=1
        )
    return tile_sorted, node_sorted


def node_rows(nodes, cfg: RenderConfig):
    """The fat-rows node attribute matrix [7|8, N] the pair gather
    pulls from.

    Layout ("fat rows"): every scalar the kernel's candidate loop
    consumes rides the pair table — (cx, cy, cz, rc = r2 - cc,
    code[, code_hi], lodr = lod^2*r, rc4 = 4r^2 - cc), 7 rows (8 past
    depth 6) — so the loop derives nothing per candidate (one
    elementwise pass over ~73k nodes instead)."""
    deep_rows = cfg.max_depth >= 7
    lod_sq_f = jnp.float32(np.float32(cfg.lod_factor) ** 2)
    cc_n = nodes["cc"]
    r2_n = nodes["r2"]
    row_list = [
        nodes["cx"], nodes["cy"], nodes["cz"],
        r2_n - cc_n,
        nodes["code"].astype(jnp.float32),
    ]
    if deep_rows:
        row_list.append(nodes["code_hi"].astype(jnp.float32))
    row_list.append(lod_sq_f * jnp.sqrt(jnp.maximum(r2_n, 0.0)))
    row_list.append(4.0 * r2_n - cc_n)
    return jnp.stack(row_list)


def bin_nodes(nodes, minv, cfg: RenderConfig, frame=None, corners=None):
    """Conservative (node, tile) pairing + one sort into tile segments.

    `frame` = (frame_w, frame_h, x_off, y_off) describes the full image
    this cfg's block is cut from (sharded rendering: each device bins
    into its own block's tiles, offset by (x_off, y_off) pixels within
    the frame whose corner-ray basis `minv` was built from). Defaults
    to the unsharded identity (cfg.width, cfg.height, 0, 0).

    `corners` = [4, 3] frame corner-ray directions (unnormalized is
    fine). When given, nodes BEHIND every corner ray are dropped: the
    kernel (like the reference, `SIMD_AVX.h:245-249`) rejects
    tca = dot(c, dir) < 0, and tca is linear in dir over the frustum
    (every frame ray is a convex combination of the corners), so
    max_i dot(c, corner_i) < 0 proves no frame ray can hit the node.
    Without this cull, behind-camera nodes take the ENTIRE tile grid
    (the conservative straddle fallback), which multiplied the pair
    table by the tile count at interior poses (round-3 verdict #8).

    Returns (pairs [7|8, cfg.pair_cap], starts [T], lens [T], n_pairs,
    pair_overflow)."""
    pair_cap = cfg.pair_cap
    n_tiles = cfg.tiles_x * cfg.tiles_y
    geo = bin_geometry(nodes, minv, cfg, frame=frame, corners=corners)
    n_pairs, pair_overflow = geo["n_pairs"], geo["pair_overflow"]
    n_nodes = geo["n_nodes"]
    tile, pair_node = _decode_tiles_window(geo, cfg, 0, pair_cap)
    tile_sorted, node_sorted = _sort_pairs(tile, pair_node, n_nodes, n_tiles)
    rows = node_rows(nodes, cfg)  # [7|8, N]
    pairs = rows[:, node_sorted]  # [R, pair_cap]
    # Dead pairs (tile == n_tiles) sit at the end; starts/lens ignore
    # them, but stamp r2 = -BIG defensively (disc = tca^2 + r2 - cc
    # can then never reach 0) so no ray test — nor an unrolled-tail or
    # window-overshoot read — can ever pass.
    dead = tile_sorted >= n_tiles
    pairs = pairs.at[3, :].set(jnp.where(dead, -_BIG, pairs[3, :]))

    bounds = jnp.searchsorted(
        tile_sorted, jnp.arange(n_tiles + 1, dtype=jnp.int32)
    )
    starts, lens = bounds[:-1], bounds[1:] - bounds[:-1]
    return pairs, starts.astype(jnp.int32), lens.astype(jnp.int32), (
        n_pairs, pair_overflow
    )


def bin_geometry(nodes, minv, cfg: RenderConfig, frame=None, corners=None):
    """Per-node screen-space geometry of the pair fill (all elementwise
    — no scatters/sorts): conservative tile ranges from interval
    arithmetic in the corner-ray basis, the behind-camera cull, and
    the pair-slot layout (counts / first / n_pairs). Shared between
    `bin_nodes` (full window) and the shared-bin sharded path
    (`parallel/shared_bin.py`, per-device slot windows)."""
    pair_cap = cfg.pair_cap
    tw, th = cfg.tile_w, cfg.tile_h
    tx_n, ty_n = cfg.tiles_x, cfg.tiles_y
    frame_w, frame_h, x_off, y_off = (
        frame if frame is not None else (cfg.width, cfg.height, 0.0, 0.0)
    )
    # NDC scale: uv' of 1.0 = frame_w pixels (original dims); the block
    # offset shifts pixel coords into block-local tile units.
    sx = frame_w / tw
    sy = frame_h / th
    ox = x_off / tw
    oy = y_off / th

    c = [nodes["cx"], nodes["cy"], nodes["cz"]]
    # Binning radius = 2r (the reference's bounding radius), NOT the
    # self radius r, even though only self-hits are tested: the f32
    # kernel's disc = tca^2 + (r^2 - |c|^2) suffers catastrophic
    # cancellation (|tca| ~ |c| ~ 8), so rays up to
    # ~|c|^2 * eps / (2r) OUTSIDE the exact r-sphere can still
    # register tangent "hits". The extra r of binning margin is what
    # keeps those numerically-borderline grazes deterministic across
    # band/shard layouts (tightening to r produced band-count-dependent
    # images at silhouettes — round-4 finding).
    rad = nodes["rad"]
    s = [
        minv[k, 0] * c[0] + minv[k, 1] * c[1] + minv[k, 2] * c[2]
        for k in range(3)
    ]
    mnorm = [jnp.sqrt(jnp.sum(minv[k] * minv[k])) for k in range(3)]
    ds = [mnorm[k] * rad for k in range(3)]

    # Interval arithmetic on u' = s0/s2, v' = s1/s2 over the sphere.
    s2_lo = s[2] - ds[2]
    s2_hi = s[2] + ds[2]
    front = s2_lo > 0.0  # safely in front of the camera plane

    def ratio_bounds(num, dnum):
        n_lo, n_hi = num - dnum, num + dnum
        cands = [
            n_lo / s2_lo, n_lo / s2_hi, n_hi / s2_lo, n_hi / s2_hi
        ]
        return (
            jnp.minimum(jnp.minimum(cands[0], cands[1]),
                        jnp.minimum(cands[2], cands[3])),
            jnp.maximum(jnp.maximum(cands[0], cands[1]),
                        jnp.maximum(cands[2], cands[3])),
        )

    u_lo, u_hi = ratio_bounds(s[0], ds[0])
    v_lo, v_hi = ratio_bounds(s[1], ds[1])

    # Tile ranges (conservative; behind-camera nodes take everything).
    # Tiles are indexed over this block's padded grid.
    tx0 = jnp.clip(jnp.floor(u_lo * sx - ox).astype(jnp.int32), 0, tx_n - 1)
    tx1 = jnp.clip(jnp.floor(u_hi * sx - ox).astype(jnp.int32), 0, tx_n - 1)
    ty0 = jnp.clip(jnp.floor(v_lo * sy - oy).astype(jnp.int32), 0, ty_n - 1)
    ty1 = jnp.clip(jnp.floor(v_hi * sy - oy).astype(jnp.int32), 0, ty_n - 1)
    tx0 = jnp.where(front, tx0, 0)
    ty0 = jnp.where(front, ty0, 0)
    tx1 = jnp.where(front, tx1, tx_n - 1)
    ty1 = jnp.where(front, ty1, ty_n - 1)
    bw = tx1 - tx0 + 1
    keep = nodes["live"]
    if corners is not None:
        cd = jnp.full_like(c[0], -1.0)
        for i in range(4):
            cd = jnp.maximum(
                cd,
                corners[i, 0] * c[0] + corners[i, 1] * c[1]
                + corners[i, 2] * c[2],
            )
        keep = keep & (cd >= 0.0)
    counts = jnp.where(keep, bw * (ty1 - ty0 + 1), 0)

    offsets = jnp.cumsum(counts)  # inclusive
    n_pairs = offsets[-1]
    pair_overflow = jnp.maximum(n_pairs - pair_cap, 0)

    # pair -> (node, tile), GATHER-FREE: scatter each live
    # node's attributes at its FIRST pair slot and fill the gaps with
    # running maxima: `first` is strictly increasing over live nodes,
    # so packing attr into the low bits of (first << k | attr) makes
    # each fill a monotone max-scan — 4 scans + 4 scatters, all
    # bandwidth-bound.
    first = offsets - counts
    n_nodes = counts.shape[0]
    return dict(
        tx0=tx0, ty0=ty0, bw=bw, counts=counts, first=first,
        n_pairs=n_pairs, n_nodes=n_nodes, pair_overflow=pair_overflow,
    )


def _camera_rays(cam, tid, lane, cfg: RenderConfig):
    """Unit ray directions of rays `lane` of frame tile `tid`, from the
    16-scalar camera pack `cam` (`camera_vector`; any indexable of 16
    scalars). `tid` is a scalar (in the kernel) or [K, 1] (in the plain
    trace). The corner interpolation (`Sphereflake.cpp:162-167`) keeps
    the association order of `camera.ray_directions`."""
    tile_w = cfg.tile_w
    txs = jax.lax.rem(tid, cfg.tiles_x)
    tys = jax.lax.div(tid, cfg.tiles_x)
    col = jax.lax.bitwise_and(lane, tile_w - 1)
    row = jax.lax.shift_right_logical(lane, tile_w.bit_length() - 1)
    fpx = (txs * tile_w + col).astype(jnp.float32)
    fpy = (tys * cfg.tile_h + row).astype(jnp.float32)
    u = (fpx + cam[12]) / cam[14]
    v = (fpy + cam[13]) / cam[15]
    d = [(cam[a] + (cam[3 + a] * u + cam[6 + a] * v)) - cam[9 + a]
         for a in range(3)]
    dnorm = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return tuple(c / dnorm for c in d)


def _acc_init(shape, shade_only: bool, deep: bool):
    """Per-ray running winner: (t, cx, cy, cz[, code_lo[, code_hi]])."""
    n = 4 if shade_only else (6 if deep else 5)
    return (jnp.full(shape, _BIG, jnp.float32),) + (
        jnp.zeros(shape, jnp.float32),
    ) * (n - 1)


def _candidate(acc, d, load, shade_only: bool, deep: bool):
    """Test one candidate against the rays `d` and keep the nearer hit.

    `load(r)` gives row r of the candidate's fat-row payload (see
    `node_rows`): a scalar in the kernel, a [K, 1] column in the plain
    trace. The tests are `SIMD_AVX.h:236-270` with the origin folded
    into the centers, plus the sqrt-free LOD gate:
    max(c1, 0)^2 < t2 + rc4 equals (c1 < 0) | (c1^2 < t2 + rc4) under
    disc >= 0, which forces t2 + rc4 >= 3r^2 > 0."""
    dx, dy, dz = d
    cx, cy, cz, rc = load(0), load(1), load(2), load(3)
    lodr = load(6 if deep else 5)
    rc4 = load(7 if deep else 6)
    tca = dx * cx + dy * cy + dz * cz
    t2 = tca * tca
    disc = t2 + rc  # r^2 - d^2
    c1p = jnp.maximum(tca - lodr, 0.0)
    ok = (tca >= 0.0) & (c1p * c1p < t2 + rc4) & (disc >= 0.0)
    ts = tca - jnp.sqrt(jnp.maximum(disc, 0.0))
    better = ok & (ts < acc[0])
    new = [ts, cx, cy, cz]
    if not shade_only:
        new.append(load(4))
        if deep:
            new.append(load(5))
    return tuple(jnp.where(better, n, o) for n, o in zip(new, acc))


def _shade(acc, d, shade_only: bool, deep: bool):
    """G-buffer rows of the winners (`render.shade_gbuffer` math):
    position = dir * t (camera-relative, `Sphereflake.cpp:186-195`),
    normal = (position - center) normalized, zeros at sky. Returns
    (min_t, code_lo[, code_hi], pos3, nrm3), or (min_t, pos3, nrm3)
    with `shade_only`; min_t is _BIG at sky."""
    bt = acc[0]
    if shade_only:
        # Every accepted t is a real distance, far below _BIG.
        hit = bt < 0.5 * _BIG
    else:
        hit = acc[4] >= 1.0
        if deep:
            hit = hit | (acc[5] >= 1.0)
    t0 = jnp.where(hit, bt, 0.0)
    pos = [da * t0 for da in d]
    w = [p - c for p, c in zip(pos, acc[1:4])]
    nn = jnp.sqrt(jnp.maximum(w[0] * w[0] + w[1] * w[1] + w[2] * w[2], 0.0))
    nn = jnp.where(nn > 0.0, nn, 1.0)
    hf = hit.astype(jnp.float32)
    nrm = [hf * (wa / nn) for wa in w]
    if shade_only:
        return (bt, *pos, *nrm)
    return (jnp.where(hit, bt, _BIG), *acc[4:], *pos, *nrm)


def _n_out(cfg: RenderConfig, shade_only: bool) -> int:
    return 7 if shade_only else (9 if cfg.max_depth >= 7 else 8)


def _trace_kernel(*refs, cfg, cam_rays, indirect, shade_only):
    """One program = one 1024-ray tile. Reads its segment bounds (and,
    with `indirect`, its frame tile id), loops over the segment's
    candidates of any length — each candidate's scalars loaded from the
    pair table in device memory — and stores the shaded rows."""
    deep = cfg.max_depth >= 7
    starts_ref, lens_ref, *rest = refs
    tmap_ref = rest.pop(0) if indirect else None
    rays_ref, pairs_ref, out_ref = rest
    k = pl.program_id(0)
    tid = tmap_ref[k] if indirect else k
    start = starts_ref[tid]
    length = lens_ref[tid]
    if cam_rays:
        lane = jax.lax.broadcasted_iota(jnp.int32, (TILE_RAYS,), 0)
        cam = [rays_ref[j] for j in range(16)]
        d = _camera_rays(cam, tid, lane, cfg)
    else:
        d = tuple(rays_ref[a, :] for a in range(3))

    def body(j, acc):
        i = start + j
        return _candidate(
            acc, d, lambda r: pairs_ref[r, i], shade_only, deep
        )

    acc = jax.lax.fori_loop(
        0, length, body, _acc_init((TILE_RAYS,), shade_only, deep)
    )
    for c, row in enumerate(_shade(acc, d, shade_only, deep)):
        out_ref[c, :] = row


def _check_rays(cfg, cam, dirs, tile_ids):
    if (cam is None) == (dirs is None):
        raise ValueError("give exactly one of cam (raygen) or dirs")
    if dirs is not None and tile_ids is not None:
        raise ValueError("tile_ids selects frame tiles; dirs bundles have none")
    if cam is not None:
        return tile_ids.shape[0] if tile_ids is not None else (
            cfg.tiles_x * cfg.tiles_y
        )
    return dirs.shape[0]


@partial(jax.jit, static_argnames=("cfg", "shade_only"))
def trace_pairs(
    pairs: Array,  # [7|8, cap] fat-row candidate table (`bin_nodes`)
    starts: Array,  # [S] int32 segment starts
    lens: Array,  # [S] int32 segment lengths
    cfg: RenderConfig,
    cam: Array | None = None,  # [16] camera pack (`camera_vector`)
    dirs: Array | None = None,  # [K, 3, TILE_RAYS] unit ray bundles
    tile_ids: Array | None = None,  # [K] int32 frame tiles (cam only)
    shade_only: bool = False,
):
    """Trace 1024-ray tiles against their binned candidate segments
    with the Pallas kernel: compiled through Triton on a GPU,
    interpreted on the CPU (`backend.kernel_route`).

    Rays come from exactly one of:
    - `cam`: in-kernel raygen for frame tile k (or `tile_ids[k]`, the
      frameless refresh's subset), segment starts[tid]/lens[tid];
    - `dirs`: bundle k's own ray directions (per-sample progressive),
      segment starts[k]/lens[k].

    Returns [K, C, TILE_RAYS] rows (min_t, code_lo[, code_hi], px, py,
    pz, nx, ny, nz) — C = 9 when cfg.max_depth >= 7, else 8 — or, with
    `shade_only`, 7 rows (min_t, pos3, nrm3): the code accumulators
    leave the loop for callers that never read codes. Not
    differentiable (inputs are stop-gradiented); gradients come from
    `binned_gbuffer`'s custom JVP."""
    K = _check_rays(cfg, cam, dirs, tile_ids)
    cam_rays = cam is not None
    indirect = tile_ids is not None
    sg = jax.lax.stop_gradient
    rays = sg(cam if cam_rays else dirs)
    inputs = [starts, lens] + ([tile_ids] if indirect else []) + [
        rays, sg(pairs)
    ]
    whole = lambda a: pl.BlockSpec(a.shape, lambda k, n=a.ndim: (0,) * n)
    in_specs = [whole(a) for a in inputs]
    if not cam_rays:
        in_specs[-2] = pl.BlockSpec(
            (None, 3, TILE_RAYS), lambda k: (k, 0, 0)
        )
    n_out = _n_out(cfg, shade_only)
    kernel = partial(
        _trace_kernel, cfg=cfg, cam_rays=cam_rays, indirect=indirect,
        shade_only=shade_only,
    )
    return pl.pallas_call(
        kernel,
        grid=(K,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((None, n_out, TILE_RAYS), lambda k: (k, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((K, n_out, TILE_RAYS), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1
        ),
        interpret=kernel_route() == "interpret",
        name="trace_pairs",
    )(*inputs)


@partial(jax.jit, static_argnames=("cfg", "shade_only"))
def trace_pairs_reference(
    pairs: Array,
    starts: Array,
    lens: Array,
    cfg: RenderConfig,
    cam: Array | None = None,
    dirs: Array | None = None,
    tile_ids: Array | None = None,
    shade_only: bool = False,
):
    """`trace_pairs` in plain `jnp`/`lax`: every tile steps through its
    segment in lockstep, to the longest segment, with a per-tile gather
    of each step's candidate and a mask past the tile's own length.
    Same arguments and rows; the reference the kernel is tested
    against."""
    K = _check_rays(cfg, cam, dirs, tile_ids)
    deep = cfg.max_depth >= 7
    pairs = jax.lax.stop_gradient(pairs)
    if cam is not None:
        tid = (tile_ids if tile_ids is not None
               else jnp.arange(K, dtype=jnp.int32))
        lane = jnp.arange(TILE_RAYS, dtype=jnp.int32)[None, :]
        d = _camera_rays(jax.lax.stop_gradient(cam), tid[:, None], lane, cfg)
    else:
        tid = jnp.arange(K, dtype=jnp.int32)
        dd = jax.lax.stop_gradient(dirs)
        d = (dd[:, 0], dd[:, 1], dd[:, 2])
    st, ln = starts[tid], lens[tid]
    last = pairs.shape[1] - 1

    def body(j, acc):
        col = pairs[:, jnp.minimum(st + j, last)]  # [R, K]
        live = j < ln

        def load(r):
            v = col[r]
            if r == 3:  # rc = -BIG past the segment: disc < 0, no hit
                v = jnp.where(live, v, -_BIG)
            return v[:, None]

        return _candidate(acc, d, load, shade_only, deep)

    acc = jax.lax.fori_loop(
        0, jnp.max(ln, initial=0), body,
        _acc_init((K, TILE_RAYS), shade_only, deep),
    )
    return jnp.stack(_shade(acc, d, shade_only, deep), axis=1)


def binned_pairs(
    scene, cfg: RenderConfig, root: Array, templates: Array, frame=None
):
    """Global expansion + binning: (pairs, starts, lens, (n_pairs,
    overflow)) — overflow counts pair-table AND deep-level compaction
    drops.

    `frame` = (frame_w, frame_h, x_off, y_off) when cfg describes one
    device's block of a larger sharded frame (see `bin_nodes`)."""
    from sphereflake.camera import corner_rays, tile_frustum_planes

    frame_w, frame_h, x_off, y_off = (
        frame if frame is not None else (cfg.width, cfg.height, 0.0, 0.0)
    )
    block_planes = tile_frustum_planes(
        scene.camera, frame_w, frame_h,
        cfg.padded_height, cfg.padded_width,
        x_off=x_off, y_off=y_off,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )[0]  # one "tile" = this device's whole block
    nodes, exp_overflow = expand_global(
        root, templates, scene.fractal, cfg, block_planes
    )
    minv = corner_basis(scene.camera, frame_w, frame_h)
    # This block's corner-ray directions (padded extent included: the
    # padded rows/cols extrapolate the corner interpolation, so the
    # hull must cover them for the behind-camera cull to be exact).
    origin, tl, tr, bl = corner_rays(scene.camera, frame_w / frame_h)
    ex, ey = tr - tl, bl - tl
    u0 = jnp.asarray(x_off, jnp.float32) / frame_w
    u1 = (jnp.asarray(x_off, jnp.float32) + cfg.padded_width) / frame_w
    v0 = jnp.asarray(y_off, jnp.float32) / frame_h
    v1 = (jnp.asarray(y_off, jnp.float32) + cfg.padded_height) / frame_h
    base = tl - origin
    corners = jnp.stack(
        [base + u * ex + v * ey for u in (u0, u1) for v in (v0, v1)]
    )
    pairs, starts, lens, (n_pairs, pair_ovf) = bin_nodes(
        nodes, minv, cfg, frame=frame, corners=corners
    )
    return pairs, starts, lens, (n_pairs, pair_ovf + exp_overflow)


def camera_vector(scene, cfg: RenderConfig, frame=None):
    """The 16-scalar camera pack consumed by the fused kernel's
    in-kernel raygen: [tl(3), ex(3), ey(3), origin(3), x_off, y_off,
    frame_w, frame_h] (`Sphereflake.cpp:162-167` corner
    parameterization)."""
    from sphereflake.camera import corner_rays

    frame_w, frame_h, x_off, y_off = (
        frame if frame is not None else (cfg.width, cfg.height, 0.0, 0.0)
    )
    origin, tl, tr, bl = corner_rays(scene.camera, frame_w / frame_h)
    ex, ey = tr - tl, bl - tl
    tail = jnp.stack(
        [
            jnp.asarray(x_off, jnp.float32),
            jnp.asarray(y_off, jnp.float32),
            jnp.float32(frame_w),
            jnp.float32(frame_h),
        ]
    )
    return jnp.concatenate([tl, ex, ey, origin, tail])


def _gbuffer_primal(statics, scene, offs):
    cfg, frame_w, frame_h = statics
    from sphereflake.models.sphereflake import child_templates, root_frame

    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    frame = (frame_w, frame_h, offs[0], offs[1])
    pairs, starts, lens, (_n, povf) = binned_pairs(
        scene, cfg, root, templates, frame=frame
    )
    cam = camera_vector(scene, cfg, frame=frame)
    out = trace_pairs(pairs, starts, lens, cfg, cam=cam)
    deep = cfg.max_depth >= 7
    flat = lambda r: out[:, r].reshape(-1)
    min_t = flat(0)
    lo = flat(1)
    hi = flat(2) if deep else jnp.zeros_like(lo)
    px, py, pz = flat(-6), flat(-5), flat(-4)
    nx, ny, nz = flat(-3), flat(-2), flat(-1)
    hit = ((lo >= 1.0) | (hi >= 1.0)).astype(jnp.float32)
    # All-float outputs so the custom-JVP tangent structure is uniform
    # (the non-differentiable ones get zero tangents; counts stay exact
    # in f32 — they are < 2^24).
    return (min_t, px, py, pz, nx, ny, nz, hit, lo, hi,
            jnp.sum(lens).astype(jnp.float32), povf.astype(jnp.float32))


@partial(jax.custom_jvp, nondiff_argnums=(0,))
def binned_gbuffer(statics, scene, offs):
    """The production forward pass: ONE trace-kernel launch computes
    raygen + binned ray tests + G-buffer shading; the XLA side only
    bins nodes and reshapes tiles to images. No `resolve_codes` re-walk
    and no dirs/shade arrays exist in the forward program.

    Differentiability is preserved by a custom JVP whose tangent
    re-derives (min_t, position, normal) from the saved path codes via
    `resolve_codes_soa` + the shading math, and differentiates that
    recomputation — the same straight-through-selection gradient the
    resolve-based forward produced (SURVEY §7 stage 5). JAX transposes
    the (linear) JVP automatically, so reverse mode (fitting) works.

    statics = (cfg, frame_w, frame_h); offs = (x_off, y_off) pixel
    offsets of this block within the frame.
    Returns flat [T*1024] arrays (min_t, px, py, pz, nx, ny, nz,
    hit(f32 0/1), code_lo, code_hi) and two f32 scalars (candidate
    tests per ray = the candidates traced, pair_overflow); min_t/pos/nrm
    carry derivatives.
    """
    return _gbuffer_primal(statics, scene, offs)


@binned_gbuffer.defjvp
def _gbuffer_jvp(statics, primals, tangents):
    cfg, frame_w, frame_h = statics
    scene, offs = primals
    d_scene, _d_offs = tangents
    outs = _gbuffer_primal(statics, scene, offs)
    lo, hi = outs[8], outs[9]
    from sphereflake.models.sphereflake import child_templates, root_frame
    from sphereflake.ops.codes import resolve_codes_soa
    from sphereflake.ops.intersect import safe_sqrt

    def h(scene):
        # Differentiable raygen for this block (same math the kernel
        # runs in f32 scalars), tiled to the kernel's flat ray order.
        from sphereflake.camera import corner_rays
        from sphereflake.render import _tile

        origin, tl, tr, bl = corner_rays(scene.camera, frame_w / frame_h)
        ex, ey = tr - tl, bl - tl
        u = (jnp.arange(cfg.padded_width, dtype=jnp.float32)[None, :]
             + offs[0]) / frame_w
        v = (jnp.arange(cfg.padded_height, dtype=jnp.float32)[:, None]
             + offs[1]) / frame_h
        comps = [(tl[a] + (ex[a] * u + ey[a] * v)) - origin[a]
                 for a in range(3)]
        dnorm = jnp.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
        dx, dy, dz = (_tile(c / dnorm, cfg).reshape(-1) for c in comps)
        root = root_frame(scene.camera.position)
        templates = child_templates(scene.fractal)
        min_t, cx, cy, cz, hit = resolve_codes_soa(
            dx, dy, dz, lo, root, templates, scene.fractal, cfg,
            code_hi_f=hi if cfg.max_depth >= 7 else None,
        )
        t0 = jnp.where(hit, min_t, 0.0)
        px, py, pz = dx * t0, dy * t0, dz * t0
        wx, wy, wz = px - cx, py - cy, pz - cz
        nn = safe_sqrt(wx * wx + wy * wy + wz * wz)
        nn = jnp.where(nn > 0, nn, 1.0)
        hf = hit.astype(jnp.float32)
        return (min_t, px, py, pz,
                hf * (wx / nn), hf * (wy / nn), hf * (wz / nn))

    _, d7 = jax.jvp(h, (scene,), (d_scene,))
    zeros = tuple(jnp.zeros_like(o) for o in outs[7:])
    return outs, d7 + zeros
