"""Parity tests for the binned traversal (global expansion + tile
binning + trace kernel). The binning must be a conservative superset of
every pixel's candidates, so results match the per-tile XLA traversal
up to f32 winner ties."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphereflake.config import RenderConfig, default_scene
from sphereflake.render import render_gbuffer


def _cfg(algorithm, **kw):
    base = dict(
        width=128, height=96, max_depth=2, tile_h=32, tile_w=32,
        max_frontier=512, algorithm=algorithm,
    )
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.parametrize("depth", [0, 2, 3])
def test_binned_matches_fast_path(depth):
    """Against the XLA fast path. Both culls are conservative, so the
    candidate sets match; the two paths evaluate the intersection in
    different f32 forms, and at depth 3 a few tangent grazes on small
    spheres flip winners (both paths deviate from the float64 golden
    there by the same ~0.3%), so t agreement is bounded as it is
    against the strict path below."""
    scene = default_scene()
    gb = render_gbuffer(scene, _cfg("binned", max_depth=depth))
    gf = render_gbuffer(scene, _cfg("fast", max_depth=depth))
    hb, hf = np.asarray(gb.hit), np.asarray(gf.hit)
    assert (hb == hf).mean() > 0.999
    both = hb & hf
    tb, tf = np.asarray(gb.min_t)[both], np.asarray(gf.min_t)[both]
    assert np.isclose(tb, tf, rtol=1e-4, atol=1e-4).mean() > 0.995


def test_binned_off_center_camera():
    """A pose where projection intervals are asymmetric."""
    scene = default_scene()
    cam = dataclasses.replace(
        scene.camera,
        yaw=scene.camera.yaw + 0.3,
        pitch=scene.camera.pitch + 0.2,
    )
    scene = dataclasses.replace(scene, camera=cam)
    gb = render_gbuffer(scene, _cfg("binned"))
    gs = render_gbuffer(scene, _cfg("strict", tile_h=32, tile_w=64))
    hb, hs = np.asarray(gb.hit), np.asarray(gs.hit)
    assert (hb == hs).mean() > 0.999
    both = hb & hs
    tb, ts = np.asarray(gb.min_t)[both], np.asarray(gs.min_t)[both]
    assert np.isclose(tb, ts, rtol=1e-4, atol=1e-4).mean() > 0.995


def test_binned_gradients_flow():
    scene = default_scene()
    cfg = _cfg("binned")

    def loss(s):
        gb = render_gbuffer(s, cfg)
        return jnp.sum(gb.position) / (cfg.width * cfg.height)

    g = jax.grad(loss)(scene)
    total = sum(
        float(jnp.sum(jnp.abs(l))) for l in jax.tree_util.tree_leaves(g)
    )
    assert np.isfinite(total) and total > 0.0


def test_binned_metrics_sane():
    gb = render_gbuffer(default_scene(), _cfg("binned"))
    assert int(gb.metrics.overflow) == 0
    assert int(gb.metrics.max_depth_reached) == 2
    assert int(gb.metrics.nodes_visited) > 0


def test_banded_matches_whole_frame():
    """Banded rendering (per-band bin+trace inside lax.map, the
    16384^2 enabler) matches the whole-frame binned render.

    Tolerances exist because this test runs the kernel in INTERPRET
    mode, where XLA fuses FMAs differently inside the lax.map body
    than in the flat program: ray dirs differing by 1 ulp flip
    TANGENT-GRAZE candidates (disc ~ 0) between hit and miss, which
    can move min_t by the gap to the next surface at a handful of
    silhouette pixels. What this test pins is the banding/offset
    LOGIC — a real offset bug breaks whole tile rows, not O(10)
    pixels."""
    import dataclasses

    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.render import render_gbuffer

    scene = default_scene()
    cfg = RenderConfig(width=256, height=128, max_depth=3, tile_h=32,
                       tile_w=32, algorithm="binned")
    gb_p = render_gbuffer(scene, cfg)
    n_pix = cfg.width * cfg.height
    for rows in (2, 1):
        gb_b = render_gbuffer(
            scene, dataclasses.replace(cfg, band_tile_rows=rows)
        )
        hit_p = np.asarray(gb_p.hit)
        hit_b = np.asarray(gb_b.hit)
        assert (hit_p != hit_b).sum() <= n_pix * 1e-3
        assert int(gb_b.metrics.overflow) == 0
        assert int(gb_b.metrics.max_depth_reached) == int(
            gb_p.metrics.max_depth_reached
        )
        mt_p, mt_b = np.asarray(gb_p.min_t), np.asarray(gb_b.min_t)
        both = hit_p & hit_b
        close = np.isclose(mt_p, mt_b, rtol=1e-5, atol=1e-5)
        assert close.mean() > 0.995
        far = np.where(both, np.abs(mt_p - mt_b), 0.0) > 1e-2
        assert far.sum() <= n_pix * 5e-4, f"{far.sum()} far-off pixels"


def test_deep_config_matches_shallow_on_shallow_scene():
    """max_depth > 7 engages the two-lane path codes and compacted
    expansion; on a scene whose LOD cut stops well before level 7 the
    output must be identical to the shallow config."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.render import render_gbuffer

    scene = default_scene()
    # The default pose's LOD cut plateaus at level 5 (closest hit ~7.2,
    # level-6 admission needs t < 6.7), so depth 6 and depth 9 see the
    # same geometry.
    kw = dict(width=128, height=64, max_depth=6, tile_h=32, tile_w=32,
              algorithm="binned")
    gb_s = render_gbuffer(scene, RenderConfig(**kw))
    kw["max_depth"] = 9
    gb_d = render_gbuffer(scene, RenderConfig(**kw))
    np.testing.assert_array_equal(np.asarray(gb_s.hit), np.asarray(gb_d.hit))
    np.testing.assert_allclose(
        np.asarray(gb_s.min_t), np.asarray(gb_d.min_t), rtol=1e-6, atol=1e-6
    )
    assert int(gb_d.metrics.overflow) == 0
    assert int(gb_d.metrics.max_depth_reached) == int(
        gb_s.metrics.max_depth_reached
    )


def dive_scene(hover: float = 0.002):
    """Camera hovering `hover` above the limit point of the nested
    child-0 chain: composing child-0 frames forever converges to a
    point with geometry at EVERY level within ~2 * r_k of it, so the
    LOD cut alone decides the depth reached — no bare-pole luck."""
    import numpy as np

    from sphereflake.config import (
        CameraParams,
        FractalParams,
        SSAOParams,
        SceneParams,
    )
    from sphereflake.models.sphereflake import child_templates, root_frame

    fractal = FractalParams.reference_default()
    templates = np.asarray(child_templates(fractal))
    root = np.asarray(root_frame(jnp.zeros(3, jnp.float32)))
    f2, r2p = root, 1.0
    centers = []
    for _ in range(14):
        tm = templates[0].copy()
        tm[:, 3] *= (1.0 + 1.0 / 3.0) * r2p
        f2 = np.concatenate(
            [f2[:, :3] @ tm[:, :3],
             (f2[:, :3] @ tm[:, 3] + f2[:, 3])[:, None]],
            axis=1,
        )
        centers.append(f2[:, 3].copy())
        r2p /= 3.0
    P = centers[-1]
    u = centers[-1] - centers[-3]
    u = u / np.linalg.norm(u)
    pos = P + hover * u

    # Solve the camera orientation for a look direction d:
    # R = Ry(pitch) @ Rx(yaw) (roll 0, `transforms.look_rotation`), so
    # R @ (0,0,-1) = (-cos(yaw) sin(pitch), sin(yaw), -cos(yaw) cos(pitch))
    # => yaw = asin(dy), pitch = atan2(-dx, -dz).
    d = -u
    yaw = np.arcsin(np.clip(d[1], -1, 1))
    pitch = np.arctan2(-d[0], -d[2])

    return SceneParams(
        camera=CameraParams(
            position=jnp.asarray(pos, jnp.float32),
            yaw=jnp.float32(yaw),
            pitch=jnp.float32(pitch),
            roll=jnp.float32(0.0),
            fov=jnp.float32(60.0),
        ),
        fractal=fractal,
        ssao=SSAOParams.reference_default(),
    )


def test_deep_dive_reaches_level_8_plus():
    """The reference's marquee interaction: diving toward the fractal
    reveals ever-deeper levels (`Sphereflake.h:146-153` unbounded
    recursion, `main.cpp:213` speed law). Hover 0.002 above a level-1
    child sphere's surface: the LOD cut t < lod^2 * r then admits
    levels > 7, which the production path must reach on its two-lane
    codes (VERDICT r2 item 6)."""
    import numpy as np

    from sphereflake.config import RenderConfig
    from sphereflake.render import render_gbuffer

    scene = dive_scene()
    cfg = RenderConfig(width=64, height=32, max_depth=10, tile_h=32,
                       tile_w=32, algorithm="binned", global_cap=1 << 15)
    gb = render_gbuffer(scene, cfg)
    assert float(np.asarray(gb.hit).mean()) > 0.5
    assert float(gb.metrics.closest_distance) < 0.02  # we really are close
    depth = int(gb.metrics.max_depth_reached)
    assert depth >= 8, f"dive only reached level {depth}"
    # Depth-11 agrees where both hit (deeper levels only ADD geometry).
    import dataclasses

    gb11 = render_gbuffer(scene, dataclasses.replace(cfg, max_depth=11))
    both = np.asarray(gb.hit) & np.asarray(gb11.hit)
    mt10 = np.asarray(gb.min_t)[both]
    mt11 = np.asarray(gb11.min_t)[both]
    assert (mt11 <= mt10 + 1e-5).mean() > 0.99


def test_depth7_boundary_parity():
    """max_depth == EXACTLY 7 — the two-lane boundary. expand_global's
    carry puts level-7 sentinels in the hi lane unconditionally, so the
    kernel must carry the hi row at depth 7, not just depth > 7 (the
    round-3 `deep = max_depth > 7` gate misreported 30% of dive-pose
    pixels as misses). Parity vs the XLA fast path, which has no lane
    split at all."""
    import numpy as np

    from sphereflake.config import RenderConfig
    from sphereflake.render import render_gbuffer

    scene = dive_scene()  # pose where level 7 is actually reached
    kw = dict(width=64, height=32, max_depth=7, tile_h=32, tile_w=32,
              global_cap=1 << 15)
    gb = render_gbuffer(
        scene, RenderConfig(algorithm="binned", **kw)
    )
    gf = render_gbuffer(
        scene,
        RenderConfig(algorithm="fast", max_frontier=1 << 14,
                     tile_batch=1, **kw),
    )
    assert int(gb.metrics.max_depth_reached) == 7
    assert int(gf.metrics.max_depth_reached) == 7
    hb, hf = np.asarray(gb.hit), np.asarray(gf.hit)
    assert (hb == hf).mean() > 0.999
    both = hb & hf
    tb, tf = np.asarray(gb.min_t)[both], np.asarray(gf.min_t)[both]
    assert np.isclose(tb, tf, rtol=1e-4, atol=1e-4).mean() > 0.995


def test_depth13_boundary_well_formed():
    """Level 13 is the deepest renderable level (two-lane f32 code
    exactness, DEEP_MAX_DEPTH): a dive close enough for the LOD cut to
    admit level 13 must produce well-formed geometry there, and
    max_depth = 14 must be rejected with the precision explanation."""
    import numpy as np
    import pytest

    from sphereflake.config import RenderConfig
    from sphereflake.render import render_gbuffer

    # Depth-13 beads (radius 3^-13 ~ 6.3e-7) need a hover of ~1e-5 to
    # subtend whole pixels at 64x32/60-deg fov. The f32 frame chain is
    # still sound there: composing 13 child frames in f32 deviates from
    # the f64 composition by only ~6e-8, a tenth of r13.
    scene = dive_scene(hover=1.25e-5)
    cfg = RenderConfig(width=64, height=32, max_depth=13, tile_h=32,
                       tile_w=32, algorithm="binned", global_cap=1 << 15)
    gb = render_gbuffer(scene, cfg)
    assert float(np.asarray(gb.hit).mean()) > 0.5
    depth = int(gb.metrics.max_depth_reached)
    assert depth >= 12, f"depth-13 dive only reached level {depth}"
    # Interior poses legitimately overflow the per-level compaction cap
    # (the LOD cut admits ~10^5 nodes this deep inside); the drop
    # policy is farthest-first, so near geometry — what this test
    # checks — survives. Zero-overflow rendering of such poses is the
    # capacity ladder's job (`grow_capacity`), not this config's.
    # Geometry is well-formed at the boundary: finite hit distances and
    # unit normals everywhere a ray hit.
    hit = np.asarray(gb.hit)
    mt = np.asarray(gb.min_t)[hit]
    assert np.isfinite(mt).all() and (mt > 0).all() and (mt < 1.0).all()
    nrm = np.asarray(gb.normal)[hit]
    nlen = np.linalg.norm(nrm, axis=-1)
    assert np.abs(nlen - 1.0).max() < 1e-3

    with pytest.raises(ValueError, match="f32"):
        RenderConfig(width=64, height=32, max_depth=14, tile_h=32,
                     tile_w=32, algorithm="binned")


def test_interior_pose_pair_count_bounded():
    """VERDICT r3 #8: behind-camera nodes used to bin to the ENTIRE
    tile grid (the conservative straddle fallback), multiplying the
    pair table at interior poses. The corner-ray cull (`bin_nodes`:
    a node can only be hit if dot(c, corner_i) >= 0 for some frame
    corner, because tca >= 0 is required and tca is linear over the
    frustum hull, `SIMD_AVX.h:245-249`) must keep an inside-the-
    geometry pose within a small multiple of the frontal pose's pair
    count."""
    import dataclasses

    import jax.numpy as jnp

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.models.sphereflake import child_templates, root_frame
    from sphereflake.ops.binned import binned_pairs

    cfg = RenderConfig(width=256, height=128, max_depth=4, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    _, _, _, (n_front, _) = binned_pairs(scene, cfg, root, templates)

    # Interior pose: camera INSIDE the root sphere's bounding volume
    # (just above the level-1 equator child), looking outward.
    cam = dataclasses.replace(
        scene.camera,
        position=jnp.asarray([0.0, 0.2, 1.1], jnp.float32),
    )
    scene_in = dataclasses.replace(scene, camera=cam)
    root_in = root_frame(cam.position)
    _, _, _, (n_inside, _) = binned_pairs(
        scene_in, cfg, root_in, templates
    )
    # Without the cull this blows up by ~the tile count (32x here);
    # with it the interior pose stays within a small factor.
    assert int(n_inside) < 4 * int(n_front), (
        f"interior pose pairs {int(n_inside)} vs frontal {int(n_front)}"
    )


def test_decode_tiles_window_composes_bit_identically():
    """The shared-bin path's foundation: decoding the pair table in D
    slot windows (with the masked-reduction carry-in at each boundary)
    must reproduce the full-window decode EXACTLY — int32 running
    maxima compose associatively."""
    import jax.numpy as jnp
    import numpy as np

    from sphereflake.camera import corner_rays, tile_frustum_planes
    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.models.sphereflake import (
        child_templates,
        root_frame,
    )
    from sphereflake.ops.binned import (
        _decode_tiles_window,
        bin_geometry,
        corner_basis,
        expand_global,
    )

    scene = default_scene()
    cfg = RenderConfig(width=256, height=128, max_depth=3, tile_h=32,
                       tile_w=32, algorithm="binned")
    root = root_frame(scene.camera.position)
    templates = child_templates(scene.fractal)
    planes = tile_frustum_planes(
        scene.camera, cfg.width, cfg.height,
        cfg.padded_height, cfg.padded_width,
        block_h=cfg.padded_height, block_w=cfg.padded_width,
    )[0]
    nodes, _ = expand_global(root, templates, scene.fractal, cfg, planes)
    minv = corner_basis(scene.camera, cfg.width, cfg.height)
    origin, tl, tr, bl = corner_rays(scene.camera, cfg.width / cfg.height)
    ex, ey = tr - tl, bl - tl
    corners = jnp.stack([
        (tl - origin) + u * ex + v * ey
        for u in (0.0, 1.0) for v in (0.0, 1.0)
    ])
    geo = bin_geometry(nodes, minv, cfg, corners=corners)

    cap = cfg.pair_cap
    tile_full, node_full = _decode_tiles_window(geo, cfg, 0, cap)
    for d in (2, 8):
        assert cap % d == 0
        w = cap // d
        tiles = jnp.concatenate(
            [_decode_tiles_window(geo, cfg, k * w, w)[0] for k in range(d)]
        )
        nodes_w = jnp.concatenate(
            [_decode_tiles_window(geo, cfg, k * w, w)[1] for k in range(d)]
        )
        np.testing.assert_array_equal(np.asarray(tiles), np.asarray(tile_full))
        np.testing.assert_array_equal(np.asarray(nodes_w), np.asarray(node_full))


def test_non_tile_multiple_frame_pads_and_crops():
    """The pad/crop path (padded extrapolation rows, `_untile` crop)
    had no CPU coverage at a non-tile-multiple size — the 1080p bench
    exercises it (1080 -> 1088 rows) but the suite never did.
    A 100x60 binned render must match the NumPy golden tracer on the
    REAL pixels, and the sharded path must agree at an uneven mesh."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.models import golden
    from sphereflake.render import render_gbuffer

    scene = default_scene()
    cfg = RenderConfig(width=100, height=60, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    assert cfg.padded_width == 128 and cfg.padded_height == 64
    gb = render_gbuffer(scene, cfg)
    assert gb.min_t.shape == (60, 100)
    res = golden.golden_render_gbuffer(100, 60, max_depth=2)
    hit_g = np.isfinite(np.asarray(res.min_t))  # golden: +inf at sky
    hit_b = np.asarray(gb.hit)
    assert (hit_g == hit_b).mean() > 0.999
    both = hit_g & hit_b
    rel = np.abs(np.asarray(gb.min_t)[both] - np.asarray(res.min_t)[both])
    rel = rel / np.abs(np.asarray(res.min_t)[both])
    # f32 kernel vs float64 golden: isolated tangent-graze winner
    # flips are legitimate; bound their count, not their magnitude.
    assert (rel > 1e-4).mean() < 2e-3, (rel > 1e-4).mean()

    import jax

    from sphereflake.parallel import make_mesh, render_gbuffer_sharded

    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    assert gb_s.min_t.shape == (60, 100)
    assert (np.asarray(gb_s.hit) == hit_b).mean() > 0.999
