"""Golden/integration tests (SURVEY §4): the JAX frontier traversal must
match the per-ray NumPy golden tracer."""

import numpy as np
import jax.numpy as jnp

from sphereflake.config import CameraParams, FractalParams, RenderConfig, default_scene
from sphereflake.models import golden
from sphereflake.ops.traversal import shade_gbuffer, trace_rays
from sphereflake.render import render_gbuffer


def _compare_to_golden(dirs64, cam_pos, cfg, atol=1e-3, miss_frac=0.0, cos_tight=0.999, frac_tight=0.99):
    import dataclasses
    cfg = dataclasses.replace(cfg, algorithm="strict")
    gold = golden.golden_trace(
        dirs64, cam_pos, max_depth=cfg.max_depth, lod_factor=cfg.lod_factor
    )
    res = trace_rays(
        jnp.asarray(dirs64, jnp.float32),
        jnp.asarray(cam_pos, jnp.float32),
        FractalParams.reference_default(),
        cfg,
    )
    hit = np.asarray(res.hit)
    ghit = np.isfinite(gold.min_t)
    mismatched = hit != ghit
    assert mismatched.mean() <= miss_frac, (
        f"hit-mask mismatch {mismatched.mean():.4%} > {miss_frac:.4%}"
    )
    both = hit & ghit
    t_err = np.abs(np.asarray(res.min_t)[both] - gold.min_t[both])
    tol = atol + 1e-3 * np.abs(gold.min_t[both])
    # f32 vs f64 can flip which of two near-coincident spheres wins at a
    # handful of grazing pixels; those show as large t jumps. Require the
    # bulk within tolerance and outliers rare.
    assert (t_err <= tol).mean() > 0.99, f"t err p99={np.percentile(t_err, 99)}"
    assert np.median(t_err) < atol
    inlier = t_err <= tol
    pos, nrm = shade_gbuffer(jnp.asarray(dirs64, jnp.float32), res)
    np.testing.assert_allclose(
        np.asarray(pos)[both][inlier], gold.position[both][inlier], atol=5 * atol, rtol=1e-3
    )
    # Normals divide by the (tiny) sphere radius, amplifying f32 noise,
    # and grazing hits are ill-conditioned — check angular error by
    # quantile instead of elementwise allclose.
    cos = np.sum(np.asarray(nrm)[both][inlier] * gold.normal[both][inlier], axis=-1)
    assert (cos > cos_tight).mean() > frac_tight, f"normal angular err: {np.sort(cos)[:5]}"
    assert (cos > 0.9).mean() > 0.999
    return res, gold


def _default_dirs(w, h):
    cam = CameraParams.reference_default()
    return (
        golden.camera_rays(
            np.asarray(cam.position), float(cam.yaw), float(cam.pitch),
            float(cam.roll), float(cam.fov), w, h,
        ),
        np.asarray(cam.position),
    )


def test_depth0_exact():
    dirs, pos = _default_dirs(32, 32)
    cfg = RenderConfig(width=128, height=64, max_depth=0)
    _compare_to_golden(dirs, pos, cfg)


def test_depth2_default_pose():
    dirs, pos = _default_dirs(64, 64)
    cfg = RenderConfig(width=128, height=64, max_depth=2)
    res, gold = _compare_to_golden(dirs, pos, cfg)
    assert int(res.max_depth_reached) == gold.max_depth_reached == 2


def test_depth4_default_pose():
    dirs, pos = _default_dirs(48, 48)
    # A single 2304-ray "tile" at depth 4 needs a large frontier cap to be
    # cap-exact vs golden (729 level-3 parents can all be wanted).
    cfg = RenderConfig(width=128, height=64, max_depth=4, max_frontier=9**4)
    # f32 boundary flips at depth 4 are allowed at a tiny rate.
    # Normals at r=1/81 amplify f32 noise ~81x; loosen the angular gate.
    _compare_to_golden(dirs, pos, cfg, miss_frac=0.002, cos_tight=0.99, frac_tight=0.97)


def test_frontier_overflow_counted_small_cap():
    # With a tiny frontier cap at depth 4 the traversal must not crash and
    # must report dropped nodes.
    dirs, pos = _default_dirs(32, 32)
    cfg = RenderConfig(width=128, height=64, max_depth=4, max_frontier=81, algorithm="strict")
    res = trace_rays(
        jnp.asarray(dirs, jnp.float32), jnp.asarray(pos, jnp.float32),
        FractalParams.reference_default(), cfg,
    )
    assert int(res.overflow) > 0


def test_lod_cut_active():
    # Put the camera far away so that the LOD cut terminates recursion:
    # with lod_factor small, children (r=1/3) at distance ~20 fail
    # sqrt(t/r) < lod and must not contribute hits.
    cam_pos = (20.0, 0.0, 0.0)
    n = 64
    ys, zs = np.meshgrid(np.linspace(-0.1, 0.1, n), np.linspace(-0.1, 0.1, n))
    dirs = np.stack([-np.ones_like(ys), ys, zs], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lod = 6.0  # lod^2 * r(child=1/3) = 12 < 18.5 = min child t
    cfg_cut = RenderConfig(width=128, height=64, max_depth=1, lod_factor=lod)
    cfg_full = RenderConfig(width=128, height=64, max_depth=1, lod_factor=70.0)
    fr = FractalParams.reference_default()
    res_cut = trace_rays(jnp.asarray(dirs, jnp.float32), jnp.asarray(cam_pos, jnp.float32), fr, cfg_cut)
    res_full = trace_rays(jnp.asarray(dirs, jnp.float32), jnp.asarray(cam_pos, jnp.float32), fr, cfg_full)
    # Cut version only sees the root sphere; full version sees children too.
    assert int(res_cut.hit.sum()) < int(res_full.hit.sum())
    assert int(res_cut.max_depth_reached) == 0
    # And the cut matches golden per-ray semantics.
    _compare_to_golden(dirs, cam_pos, cfg_cut)
    _compare_to_golden(dirs, cam_pos, cfg_full)


def test_full_frame_render_matches_golden():
    cfg = RenderConfig(width=256, height=128, max_depth=2, tile_h=64, tile_w=128)
    scene = default_scene()
    gb = render_gbuffer(scene, cfg)
    gold = golden.golden_render_gbuffer(cfg.width, cfg.height, max_depth=2)
    ghit = np.isfinite(gold.min_t)
    hit = np.asarray(gb.hit)
    assert (hit == ghit).mean() > 0.999
    both = hit & ghit
    np.testing.assert_allclose(np.asarray(gb.min_t)[both], gold.min_t[both], atol=1e-3, rtol=1e-3)
    cos = np.sum(np.asarray(gb.normal)[both] * gold.normal[both], axis=-1)
    assert (cos > 0.999).mean() > 0.99
    # Metrics sanity
    assert int(gb.metrics.max_depth_reached) == 2
    assert float(gb.metrics.closest_distance) < 10.0
    assert int(gb.metrics.rays_traced) == cfg.width * cfg.height


def test_tile_batching_invariance():
    scene = default_scene()
    cfg_a = RenderConfig(width=256, height=128, max_depth=2, tile_h=64, tile_w=128, tile_batch=1)
    cfg_b = RenderConfig(width=256, height=128, max_depth=2, tile_h=64, tile_w=128, tile_batch=8)
    cfg_c = RenderConfig(width=256, height=128, max_depth=2, tile_h=128, tile_w=256, tile_batch=1)
    ga = render_gbuffer(scene, cfg_a)
    gb = render_gbuffer(scene, cfg_b)
    gc = render_gbuffer(scene, cfg_c)
    np.testing.assert_array_equal(np.asarray(ga.hit), np.asarray(gb.hit))
    np.testing.assert_allclose(np.asarray(ga.min_t), np.asarray(gb.min_t), atol=0)
    # Different tile shapes may reorder float ops only negligibly.
    assert (np.asarray(ga.hit) == np.asarray(gc.hit)).mean() > 0.9999
    both = np.asarray(ga.hit) & np.asarray(gc.hit)
    np.testing.assert_allclose(
        np.asarray(ga.min_t)[both], np.asarray(gc.min_t)[both], atol=1e-5, rtol=1e-5
    )


def test_loose_mode_close_to_strict():
    dirs, pos = _default_dirs(48, 48)
    fr = FractalParams.reference_default()
    cfg_s = RenderConfig(width=128, height=64, max_depth=3, algorithm="strict", strict_lod=True)
    cfg_l = RenderConfig(width=128, height=64, max_depth=3, algorithm="loose", strict_lod=False)
    cfg_f = RenderConfig(width=128, height=64, max_depth=3, algorithm="fast")
    rs = trace_rays(jnp.asarray(dirs, jnp.float32), jnp.asarray(pos, jnp.float32), fr, cfg_s)
    rl = trace_rays(jnp.asarray(dirs, jnp.float32), jnp.asarray(pos, jnp.float32), fr, cfg_l)
    rf = trace_rays(jnp.asarray(dirs, jnp.float32), jnp.asarray(pos, jnp.float32), fr, cfg_f)
    # At close range with no LOD activity all three gatings agree exactly.
    np.testing.assert_array_equal(np.asarray(rs.hit), np.asarray(rl.hit))
    np.testing.assert_allclose(np.asarray(rs.min_t), np.asarray(rl.min_t), atol=0)
    np.testing.assert_array_equal(np.asarray(rs.hit), np.asarray(rf.hit))
    np.testing.assert_allclose(np.asarray(rs.min_t), np.asarray(rf.min_t), atol=0)
