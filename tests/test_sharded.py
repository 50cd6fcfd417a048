"""Distributed tests on the 8-virtual-CPU-device mesh (SURVEY §4):
sharded render parity vs single-device, and sharded gradient psum."""

import numpy as np
import jax
import jax.numpy as jnp

from sphereflake.config import RenderConfig, default_scene
from sphereflake.parallel import (
    fit_step_sharded,
    make_mesh,
    render_gbuffer_sharded,
)
from sphereflake.render import render_gbuffer


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_mesh_shapes():
    m = make_mesh()
    assert m.devices.size == 8
    assert m.axis_names == ("ty", "tx")
    m2 = make_mesh(shape=(2, 4))
    assert m2.devices.shape == (2, 4)


def test_sharded_render_matches_single_device():
    cfg = RenderConfig(width=512, height=256, max_depth=2, tile_h=64, tile_w=128)
    scene = default_scene()
    mesh = make_mesh(shape=(4, 2))
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    # Sharded output must be placement-invariant: identical hits and
    # bit-close buffers (the per-tile math is identical; only tile
    # grouping differs, which does not change any per-ray op here).
    np.testing.assert_array_equal(np.asarray(gb_s.hit), np.asarray(gb_1.hit))
    np.testing.assert_allclose(
        np.asarray(gb_s.min_t), np.asarray(gb_1.min_t), atol=1e-6, rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(gb_s.normal), np.asarray(gb_1.normal), atol=1e-5
    )
    # metrics agree
    assert int(gb_s.metrics.max_depth_reached) == int(gb_1.metrics.max_depth_reached)
    np.testing.assert_allclose(
        float(gb_s.metrics.closest_distance),
        float(gb_1.metrics.closest_distance),
        rtol=1e-6,
    )


def test_sharded_render_1d_mesh():
    cfg = RenderConfig(width=256, height=512, max_depth=1, tile_h=64, tile_w=128)
    scene = default_scene()
    mesh = make_mesh(shape=(8, 1))
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    np.testing.assert_array_equal(np.asarray(gb_s.hit), np.asarray(gb_1.hit))


def test_sharded_fit_step_gradients():
    cfg = RenderConfig(width=256, height=128, max_depth=1, tile_h=64, tile_w=128)
    scene = default_scene()
    mesh = make_mesh(shape=(2, 2), devices=jax.devices()[:4])
    target = render_gbuffer(scene, cfg)

    # At the optimum the gradient is ~0 and loss is 0.
    loss0, grads0 = fit_step_sharded(
        scene, target.position, target.normal, cfg, mesh
    )
    assert float(loss0) < 1e-10

    # Perturb the camera: loss > 0 and gradient points somewhere.
    import dataclasses

    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.02)
    scene_p = dataclasses.replace(scene, camera=cam)
    loss1, grads1 = fit_step_sharded(
        scene_p, target.position, target.normal, cfg, mesh
    )
    assert float(loss1) > 1e-4
    g_yaw = float(grads1.camera.yaw)
    assert np.isfinite(g_yaw) and abs(g_yaw) > 1e-6

    # And the psum'd gradient equals the single-device gradient.
    def single_loss(s):
        gb = render_gbuffer(s, cfg)
        return (
            jnp.sum((gb.position - target.position) ** 2)
            + jnp.sum((gb.normal - target.normal) ** 2)
        ) / (cfg.width * cfg.height)

    g_single = jax.grad(single_loss)(scene_p)
    np.testing.assert_allclose(
        g_yaw, float(g_single.camera.yaw), rtol=2e-3, atol=1e-7
    )
    np.testing.assert_allclose(
        float(loss1), float(single_loss(scene_p)), rtol=1e-5
    )


def test_sharded_render_binned_matches_single_device():
    """The binned production path under shard_map: every device expands
    globally but bins into its own block's tiles with the block's pixel
    offset — output must match the single-device binned render."""
    cfg = RenderConfig(
        width=256, height=128, max_depth=3, tile_h=32, tile_w=32,
        max_frontier=128, algorithm="binned",
    )
    scene = default_scene()
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    assert int(gb_s.metrics.overflow) == 0
    # Same per-ray tests against (a superset of) the same candidates;
    # the sharded block path computes dirs with AoS `ray_directions`
    # while the single-device SoA pipeline computes them per-component,
    # and at this depth the image is dense with level-3 silhouettes
    # where a ulp of dir flips a grazing d2<=r2 test and swaps the
    # winner outright (verified: every flip is a silhouette pixel, NOT
    # a block-boundary binning error — the mismatch locations are
    # interior to blocks and the flipped values match the strict path).
    hs, h1 = np.asarray(gb_s.hit), np.asarray(gb_1.hit)
    assert (hs != h1).mean() < 1e-3
    both = hs & h1
    agree = np.isclose(
        np.asarray(gb_s.min_t)[both], np.asarray(gb_1.min_t)[both],
        atol=1e-4, rtol=1e-4,
    )
    assert agree.mean() > 0.995


def test_sharded_banded_blocks_2x2_match_single_device():
    """The per-block binned path (each device expands and bins its own
    block, in bands) under a 2x2 shard_map matches the single-device
    render; banding rules out the shared-bin path here."""
    from sphereflake.parallel.shared_bin import shared_bin_supported

    cfg = RenderConfig(
        width=256, height=128, max_depth=2, tile_h=32, tile_w=32,
        max_frontier=128, algorithm="binned", band_tile_rows=1,
    )
    scene = default_scene()
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    assert not shared_bin_supported(cfg, mesh)
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    np.testing.assert_array_equal(np.asarray(gb_s.hit), np.asarray(gb_1.hit))
    # Per-block bins see other frusta than the whole-frame bin, so
    # isolated near-tie winner flips are legitimate; everything else
    # matches to f32 noise.
    agree = np.isclose(
        np.asarray(gb_s.min_t), np.asarray(gb_1.min_t), atol=1e-4, rtol=1e-4
    )
    assert agree.mean() > 0.999


def test_render_frame_sharded_matches_single():
    """VERDICT r3 #3: the COMPLETE pipeline — trace + SSAO + blur x2 +
    composite (`main.cpp:301-335`, `SSAO.cpp:106-142`) — sharded over
    the mesh. SSAO taps cross block borders (radius law
    `post_ssao.glsl:42`), so the post stage all-gathers the G-buffer
    planes and each device evaluates its own block of each pass; the
    result must match the single-device `render_frame` bit-for-bit up
    to the usual interpret-mode silhouette fuzz."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import make_mesh, render_frame_sharded
    from sphereflake.render import render_frame

    scene = default_scene()
    cfg = RenderConfig(width=256, height=128, max_depth=3, tile_h=32,
                       tile_w=32, algorithm="binned")
    mesh = make_mesh(jax.devices()[:8])
    img_s, gb_s = render_frame_sharded(scene, cfg, mesh)
    img_1, gb_1 = render_frame(scene, cfg)
    a, b = np.asarray(img_s), np.asarray(img_1)
    close = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert close.mean() > 0.999, f"only {close.mean():.4%} pixels match"
    assert np.isfinite(a).all()
    # The G-buffer underneath agrees too.
    assert (np.asarray(gb_s.hit) == np.asarray(gb_1.hit)).mean() > 0.999


def test_banded_blocks_compose_with_sharding():
    """VERDICT r3 #4: bands must compose UNDER shard_map — each
    device's block renders its own bands (a band is just a further
    y-offset sub-block of the same frame). Forced per-block banding
    must match the unbanded sharded render and the single-device
    banded render."""
    import dataclasses

    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import make_mesh, render_gbuffer_sharded
    from sphereflake.render import render_gbuffer

    scene = default_scene()
    mesh = make_mesh(jax.devices()[:8])  # 2x4
    cfg = RenderConfig(width=256, height=128, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned", band_tile_rows=1)
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    n_pix = cfg.width * cfg.height
    hs, h1 = np.asarray(gb_s.hit), np.asarray(gb_1.hit)
    assert (hs != h1).sum() <= n_pix * 1e-3
    assert int(gb_s.metrics.overflow) == 0
    mt_s, mt_1 = np.asarray(gb_s.min_t), np.asarray(gb_1.min_t)
    agree = np.isclose(mt_s, mt_1, rtol=1e-4, atol=1e-4)
    assert agree.mean() > 0.995


def test_render_frame_sharded_downscaled_ssao():
    """SSAO downscale under the mesh: 256x128/ds=2 tiles evenly (the
    SHARDED downscaled-AO path), 160x128/ds=4 does not (the replicated
    fallback). Both must match single-device."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import make_mesh, render_frame_sharded
    from sphereflake.render import render_frame

    scene = default_scene()
    mesh = make_mesh(jax.devices()[:8])  # 2x4
    for w, h, ds in ((256, 128, 2), (160, 128, 4)):
        cfg = RenderConfig(width=w, height=h, max_depth=2, tile_h=32,
                           tile_w=32, algorithm="binned", ssao_downscale=ds)
        img_s, _ = render_frame_sharded(scene, cfg, mesh)
        img_1, _ = render_frame(scene, cfg)
        close = np.isclose(np.asarray(img_s), np.asarray(img_1),
                           rtol=1e-4, atol=1e-4).all(axis=-1)
        assert close.mean() > 0.999, (w, h, ds, close.mean())


def test_render_frames_dp_matches_sequential():
    """Frame-data-parallel rendering: N devices render N DIFFERENT
    frames through the full pipeline — the answer to
    small-frame fleets (screen-tile sharding of one small frame is
    fixed-cost-limited). Batched output must match sequential
    single-device renders."""
    import dataclasses

    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import make_frame_mesh, render_frames_dp
    from sphereflake.render import render_frame

    scene = default_scene()
    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    devs = jax.devices()[:8]
    mesh = make_frame_mesh(devs)
    scenes = [
        dataclasses.replace(
            scene,
            camera=dataclasses.replace(
                scene.camera, yaw=scene.camera.yaw + 0.02 * i
            ),
        )
        for i in range(len(devs))
    ]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *scenes)
    imgs, ovf = render_frames_dp(batched, cfg, mesh)
    imgs = np.asarray(imgs)
    assert imgs.shape == (8, 64, 128, 3)
    assert int(np.asarray(ovf).sum()) == 0
    for i in (0, 3, 7):
        ref, _ = render_frame(scenes[i], cfg)
        close = np.isclose(imgs[i], np.asarray(ref), rtol=1e-4,
                           atol=1e-4).all(axis=-1)
        assert close.mean() > 0.999, (i, close.mean())
    # Frames genuinely differ (different cameras).
    assert np.abs(imgs[0] - imgs[7]).max() > 0.01

def test_sharded_frameless_matches_single_device_tiles():
    """VERDICT r4 item 3: all devices share one frameless buffer
    (`Sphereflake.cpp:67-74`). Each device refreshes Sobol-chosen tiles
    of its own block through the SAME kernel invocation a single-device
    run uses (same global tile id, camera vector, pair table), so at
    full coverage the sharded state must equal the single-device
    frameless state tile-for-tile — and the full render."""
    from sphereflake.parallel import (
        sharded_tiles_as_single,
        sharded_tiles_init,
        sharded_tiles_step,
    )
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_gbuffer,
    )

    cfg = RenderConfig(width=256, height=128, max_depth=3, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    mesh = make_mesh(shape=(2, 4))  # tiles 4x8 -> 2x2 per device
    T = cfg.tiles_y * cfg.tiles_x
    prepared = progressive_prepare(scene, cfg)

    st_s = sharded_tiles_init(cfg, mesh, seed=5)
    for _ in range(8):  # 8 steps x 4 tiles/device x 8 devices >> 32 tiles
        st_s = sharded_tiles_step(
            st_s, scene, cfg, mesh, tiles_per_device=4, prepared=prepared
        )
    assert int(np.asarray(st_s.covered).sum()) == T
    assert int(st_s.overflow) == 0

    st_1 = progressive_tiles_init(cfg, seed=5)
    for _ in range(10):
        st_1 = progressive_tiles_step(
            st_1, scene, cfg, tiles_per_step=8, prepared=prepared
        )
    assert int(np.asarray(st_1.covered).sum()) == T

    view = sharded_tiles_as_single(st_s)
    np.testing.assert_array_equal(
        np.asarray(view.rows), np.asarray(st_1.rows)
    )
    # And both equal the full render.
    pos_s, nrm_s, mt_s, _ = tile_progressive_gbuffer(view, cfg)
    gb = render_gbuffer(scene, cfg)
    assert (np.asarray(mt_s) == np.asarray(gb.min_t)).mean() > 0.99
    np.testing.assert_allclose(
        float(st_s.closest_distance), float(st_1.closest_distance),
        rtol=1e-6,
    )


def test_sharded_frameless_partial_coverage_is_block_local():
    """Before convergence each device has only touched its own block:
    covered tiles of device (iy, ix) all lie inside its block."""
    from sphereflake.parallel import (
        sharded_tiles_init,
        sharded_tiles_step,
    )
    from sphereflake.runtime.progressive import progressive_prepare

    cfg = RenderConfig(width=256, height=128, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    mesh = make_mesh(shape=(4, 2))
    prepared = progressive_prepare(scene, cfg)
    st = sharded_tiles_init(cfg, mesh, seed=1)
    st = sharded_tiles_step(
        st, scene, cfg, mesh, tiles_per_device=1, prepared=prepared
    )
    cov = np.asarray(st.covered)  # [4, 8] tiles
    # Exactly one tile per device block refreshed.
    assert cov.sum() == 8
    for iy in range(4):
        for ix in range(2):
            blk = cov[iy : iy + 1, ix * 4 : (ix + 1) * 4]
            assert blk.sum() == 1

def test_shared_bin_matches_single_device():
    """VERDICT r4 item 4: strong scaling by sharing the bin stage. The
    shared-bin path (one cooperative bin: sharded fill windows with
    exact carry-in, replicated sort, sharded gather + kernel blocks)
    must reproduce the single-device render — hit-identical, ulp-close
    values (cross-program XLA fusion can contract cc/rc differently,
    flipping tangent-graze bits) — and identical metrics."""
    from sphereflake.parallel import shared_bin_supported
    from sphereflake.parallel.shared_bin import render_gbuffer_shared

    cfg = RenderConfig(width=256, height=128, max_depth=3, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    mesh = make_mesh(shape=(2, 4))
    assert shared_bin_supported(cfg, mesh)
    gb_s = render_gbuffer_shared(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    assert (np.asarray(gb_s.hit) == np.asarray(gb_1.hit)).mean() > 0.9995
    mt_s, mt_1 = np.asarray(gb_s.min_t), np.asarray(gb_1.min_t)
    assert (mt_s == mt_1).mean() > 0.995
    # The rare mismatches are tangent-graze winner flips (a 1-ulp disc
    # difference promotes a different sphere); their count is bounded,
    # not their magnitude.
    both = np.asarray(gb_s.hit) & np.asarray(gb_1.hit)
    rel = np.abs(mt_s[both] - mt_1[both]) / np.abs(mt_1[both])
    assert (rel > 1e-4).mean() < 0.002, (rel > 1e-4).mean()
    assert int(gb_s.metrics.max_depth_reached) == int(
        gb_1.metrics.max_depth_reached
    )
    assert int(gb_s.metrics.nodes_visited) == int(
        gb_1.metrics.nodes_visited
    )
    assert int(gb_s.metrics.overflow) == int(gb_1.metrics.overflow) == 0


def test_shared_bin_is_default_sharded_path_and_differentiable():
    """`render_gbuffer_sharded` routes eligible binned configs through
    the shared-bin pipeline, and gradients flow through its custom JVP
    (image-loss fitting over a mesh differentiates this path)."""
    import jax

    from sphereflake.parallel import shared_bin_supported
    from sphereflake.render import render_gbuffer

    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    mesh = make_mesh(shape=(2, 4))
    assert shared_bin_supported(cfg, mesh)
    gb_s = render_gbuffer_sharded(scene, cfg, mesh)
    gb_1 = render_gbuffer(scene, cfg)
    assert (np.asarray(gb_s.min_t) == np.asarray(gb_1.min_t)).mean() > 0.99

    def loss(s):
        gb = render_gbuffer_sharded(s, cfg, mesh)
        return jnp.sum(gb.position ** 2) / (cfg.width * cfg.height)

    g = jax.grad(loss)(scene)
    g1 = jax.grad(
        lambda s: jnp.sum(render_gbuffer(s, cfg).position ** 2)
        / (cfg.width * cfg.height)
    )(scene)
    # The tangent recompute is the same straight-through resolve the
    # single-device custom JVP uses.
    np.testing.assert_allclose(
        float(g.camera.yaw), float(g1.camera.yaw), rtol=1e-3
    )

def test_image_loss_fit_over_mesh():
    """CLI-reachable path (`--fit-loss image` on a multi-device host):
    the image loss differentiates render_frame_sharded — through the
    shared-bin custom JVP AND the sharded post chain's collectives —
    and descends."""
    import dataclasses

    import optax

    from sphereflake.fit import fit, ssao_only
    from sphereflake.parallel import render_frame_sharded

    scene = default_scene()
    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    target, _ = render_frame_sharded(scene, cfg, mesh)
    off = dataclasses.replace(
        scene, ssao=dataclasses.replace(
            scene.ssao, intensity=scene.ssao.intensity + 0.3
        )
    )
    res = fit(
        off, None, None, cfg, steps=3, optimizer=optax.adam(2e-2),
        param_filter=ssao_only, loss="image", target_image=target,
        mesh=mesh,
    )
    assert res.losses[-1] < res.losses[0]
