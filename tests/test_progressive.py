"""Frameless progressive accumulation tests (config-3 behavior)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from sphereflake.config import RenderConfig, default_scene
from sphereflake.render import render_gbuffer
from sphereflake.runtime.progressive import (
    progressive_init,
    progressive_step,
    reset_closest_distance,
)


CFG = RenderConfig(width=128, height=64, max_depth=2)


def test_coverage_grows_and_converges_to_full_frame():
    scene = default_scene()
    state = progressive_init(CFG, seed=7)
    covered_prev = 0
    for _ in range(6):
        state = progressive_step(state, scene, CFG, batch_size=4096)
        covered = int((np.asarray(state.min_t) != np.float32(3.0e38)).sum())
        # min_t written even for misses? misses write _BIG -> count hits via normals
        covered = int((np.linalg.norm(np.asarray(state.normal), axis=-1) > 0).sum())
        assert covered >= covered_prev
        covered_prev = covered
    assert covered_prev > 500  # plenty of the fractal sampled

    # Progressive samples agree with the full-frame render at their pixels.
    gb = render_gbuffer(scene, CFG)
    touched = np.linalg.norm(np.asarray(state.normal), axis=-1) > 0
    np.testing.assert_allclose(
        np.asarray(state.position)[touched],
        np.asarray(gb.position)[touched],
        atol=1e-4,
    )


def test_deterministic_given_seed():
    scene = default_scene()
    a = progressive_step(progressive_init(CFG, seed=3), scene, CFG, batch_size=2048)
    b = progressive_step(progressive_init(CFG, seed=3), scene, CFG, batch_size=2048)
    np.testing.assert_array_equal(np.asarray(a.position), np.asarray(b.position))
    c = progressive_step(progressive_init(CFG, seed=4), scene, CFG, batch_size=2048)
    assert (np.asarray(a.position) != np.asarray(c.position)).any()


def test_cursor_advances():
    scene = default_scene()
    s0 = progressive_init(CFG)
    s1 = progressive_step(s0, scene, CFG, batch_size=1024)
    s2 = progressive_step(s1, scene, CFG, batch_size=1024)
    assert int(s1.sample_lo) == 1024 and int(s2.sample_lo) == 2048
    assert int(s2.samples_traced) == 2048


def test_view_change_mid_stream_overwrites():
    # The frameless property: changing the camera between steps just makes
    # new samples overwrite stale texels (`main.cpp:304`, SetView
    # mid-flight).
    scene = default_scene()
    state = progressive_init(CFG, seed=1)
    for _ in range(3):
        state = progressive_step(state, scene, CFG, batch_size=4096)
    cam2 = dataclasses.replace(scene.camera, position=scene.camera.position + 2.0)
    scene2 = dataclasses.replace(scene, camera=cam2)
    state2 = state
    for _ in range(3):
        state2 = progressive_step(state2, scene2, CFG, batch_size=4096)
    # State changed where resampled
    assert (np.asarray(state2.position) != np.asarray(state.position)).any()


def test_closest_distance_metric_and_reset():
    scene = default_scene()
    state = progressive_step(progressive_init(CFG), scene, CFG, batch_size=4096)
    gb = render_gbuffer(scene, CFG)
    assert float(state.closest_distance) >= float(gb.metrics.closest_distance) - 1e-5
    assert float(state.closest_distance) < 20.0
    state = reset_closest_distance(state)
    assert float(state.closest_distance) > 1e30


def test_scramble_modes():
    scene = default_scene()
    a = progressive_step(progressive_init(CFG, 5), scene, CFG, 2048, "fixed")
    b = progressive_step(progressive_init(CFG, 5), scene, CFG, 2048, "per_sample")
    assert (np.asarray(a.normal) != np.asarray(b.normal)).any()


def test_progressive_binned_matches_strict_path():
    """The per-sample binned step (bundled ray input to the trace
    kernel) agrees with the strict XLA path's per-sample step, normals
    included, and rejects batches that are not whole bundles."""
    import dataclasses

    import pytest

    cfg_s = RenderConfig(width=96, height=64, max_depth=2, tile_h=32,
                         tile_w=32, max_frontier=128, algorithm="strict")
    cfg_b = dataclasses.replace(cfg_s, algorithm="binned")
    scene = default_scene()

    ss = progressive_init(cfg_s, seed=3)
    sb = progressive_init(cfg_b, seed=3)
    for _ in range(2):
        ss = progressive_step(ss, scene, cfg_s, batch_size=1024)
        sb = progressive_step(sb, scene, cfg_b, batch_size=1024)

    # Same sample stream, same scatter policy -> same covered pixels.
    cov_s = np.asarray(ss.min_t) < 1e30
    cov_b = np.asarray(sb.min_t) < 1e30
    assert (cov_s == cov_b).mean() > 0.999
    both = cov_s & cov_b
    ts, tb = np.asarray(ss.min_t)[both], np.asarray(sb.min_t)[both]
    close = np.isclose(ts, tb, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.995
    nd = np.abs(np.asarray(ss.normal)[both][close]
                - np.asarray(sb.normal)[both][close])
    assert (nd.max(axis=-1) < 1e-3).mean() > 0.98
    with pytest.raises(ValueError, match="batch_size"):
        progressive_step(sb, scene, cfg_b, batch_size=1000)


def test_progressive_binned_matches_fast_path():
    """The binned production path serves the frameless mode: bundles
    consume the contiguous pair-segment span of the tiles they touch
    through the windowed kernel."""
    import dataclasses

    cfg_f = RenderConfig(width=96, height=64, max_depth=2, tile_h=32,
                         tile_w=32, max_frontier=128, algorithm="fast")
    cfg_b = dataclasses.replace(cfg_f, algorithm="binned")
    scene = default_scene()

    sf = progressive_init(cfg_f, seed=3)
    sb = progressive_init(cfg_b, seed=3)
    for _ in range(3):
        sf = progressive_step(sf, scene, cfg_f, batch_size=1024)
        sb = progressive_step(sb, scene, cfg_b, batch_size=1024)

    cov_f = np.asarray(sf.min_t) < 1e30
    cov_b = np.asarray(sb.min_t) < 1e30
    assert (cov_f == cov_b).mean() > 0.999
    both = cov_f & cov_b
    tf, tb = np.asarray(sf.min_t)[both], np.asarray(sb.min_t)[both]
    assert np.isclose(tf, tb, rtol=1e-4, atol=1e-4).mean() > 0.995
    assert int(sb.samples_traced) == 3 * 1024


def test_progressive_duplicate_pixels_deterministic():
    """Duplicates in one batch resolve deterministically (last sample
    wins), unlike the reference's racy scatter — run twice, compare."""
    cfg = RenderConfig(width=16, height=16, max_depth=1, tile_h=16,
                       tile_w=16, max_frontier=128)
    scene = default_scene()
    # Tiny image + large batch forces many duplicate pixels per batch.
    a = progressive_step(progressive_init(cfg, seed=1), scene, cfg,
                         batch_size=4096, scramble="per_sample")
    b = progressive_step(progressive_init(cfg, seed=1), scene, cfg,
                         batch_size=4096, scramble="per_sample")
    np.testing.assert_array_equal(np.asarray(a.position), np.asarray(b.position))
    np.testing.assert_array_equal(np.asarray(a.min_t), np.asarray(b.min_t))


def test_prepared_pairs_match_unprepared():
    """`progressive_prepare` hoists the frame binning out of the step
    (VERDICT r3 item 5: re-binning per step cost ~50x the useful
    kernel work); with a static camera the cached pair table must give
    BIT-IDENTICAL steps."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.progressive import (
        progressive_init,
        progressive_prepare,
        progressive_step,
    )

    scene = default_scene()
    cfg = RenderConfig(width=96, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    prepared = progressive_prepare(scene, cfg)
    s_a = progressive_init(cfg, seed=7)
    s_b = progressive_init(cfg, seed=7)
    for _ in range(3):
        s_a = progressive_step(s_a, scene, cfg, batch_size=1024)
        s_b = progressive_step(s_b, scene, cfg, batch_size=1024,
                               prepared=prepared)
    np.testing.assert_array_equal(np.asarray(s_a.min_t), np.asarray(s_b.min_t))
    np.testing.assert_array_equal(np.asarray(s_a.normal), np.asarray(s_b.normal))
    assert int(s_a.samples_traced) == int(s_b.samples_traced)


def test_tile_progressive_matches_full_render():
    """Tile-granular frameless mode: whole 1024-ray TILES are the
    refresh unit (the reference refreshes 8-ray packets; tiles are
    dense block writes instead of per-pixel scatters).
    Covered tiles must match the full render (up to interpret-mode
    tangent fuzz, cf. test_binned's banded note), uncovered tiles stay
    sky, and coverage accumulates across steps."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.render import render_gbuffer
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_gbuffer,
    )

    scene = default_scene()
    cfg = RenderConfig(width=256, height=128, max_depth=3, tile_h=32,
                       tile_w=32, algorithm="binned")
    T = cfg.tiles_y * cfg.tiles_x
    prepared = progressive_prepare(scene, cfg)
    st = progressive_tiles_init(cfg, seed=1)
    st = progressive_tiles_step(st, scene, cfg, tiles_per_step=8,
                                prepared=prepared)
    assert 0 < int(np.asarray(st.covered).sum()) <= 8
    for _ in range(9):
        st = progressive_tiles_step(st, scene, cfg, tiles_per_step=8,
                                    prepared=prepared)
    cov = np.asarray(st.covered)
    assert cov.sum() == T  # 80 Sobol draws cover all 32 tiles

    pos, nrm, mt, hit = tile_progressive_gbuffer(st, cfg)
    gb = render_gbuffer(scene, cfg)
    mt_a, mt_b = np.asarray(mt), np.asarray(gb.min_t)
    same = (mt_a == mt_b).mean()
    assert same > 0.99, f"only {same:.4f} of pixels bit-match"
    close = np.isclose(np.asarray(pos), np.asarray(gb.position),
                       rtol=1e-4, atol=1e-4).mean()
    assert close > 0.99
    assert int(st.samples_traced) == 80 * 1024

def test_tile_progressive_composite_matches_render_frame():
    """VERDICT r4 item 2: the frameless display loop. The full post
    chain (SSAO -> blur x2 -> composite, `main.cpp:301-335`) over the
    accumulated in-flight buffer must, at full coverage, equal
    `render_frame` of the same scene."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.render import render_frame
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_composite,
    )

    scene = default_scene()
    cfg = RenderConfig(width=128, height=96, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    T = cfg.tiles_y * cfg.tiles_x
    prepared = progressive_prepare(scene, cfg)
    st = progressive_tiles_init(cfg, seed=2)
    for _ in range(6):
        st = progressive_tiles_step(st, scene, cfg, tiles_per_step=T,
                                    prepared=prepared)
    assert int(np.asarray(st.covered).sum()) == T
    img_frameless = np.asarray(tile_progressive_composite(st, scene, cfg))
    img_full, _gb = render_frame(scene, cfg)
    close = np.isclose(img_frameless, np.asarray(img_full),
                       rtol=1e-4, atol=1e-4).mean()
    assert close > 0.995, f"composite parity only {close:.4f}"


def test_tile_progressive_mid_flight_composite_runs():
    """The post chain must also run over a PARTIALLY covered buffer
    (the reference's display thread composites whatever is there every
    vsync, including unwritten sky texels)."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_composite,
    )

    scene = default_scene()
    cfg = RenderConfig(width=128, height=96, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    prepared = progressive_prepare(scene, cfg)
    st = progressive_tiles_init(cfg, seed=2)
    st = progressive_tiles_step(st, scene, cfg, tiles_per_step=3,
                                prepared=prepared)
    img = np.asarray(tile_progressive_composite(st, scene, cfg))
    assert img.shape == (96, 128, 3)
    assert np.isfinite(img).all()


def test_frameless_animate_overwrites_stale_tiles():
    """VERDICT r4 item 7 (SetView mid-flight, `main.cpp:304`): the
    camera moves WHILE the same buffer keeps accumulating — tiles
    refreshed under the new view must change, unrefreshed tiles keep
    the previous view's content."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.animate import frameless_animate

    scene = default_scene()
    cfg = RenderConfig(width=128, height=96, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    frames = list(
        frameless_animate(
            scene, cfg, 3, steps_per_frame=2, tiles_per_step=3,
            mode="orbit", composite=False, seed=4,
        )
    )
    assert len(frames) == 3
    img0, _s0, st0 = frames[0]
    img1, _s1, st1 = frames[1]
    assert img0.shape == (96, 128, 3)
    # Accumulation persists across camera steps (samples keep growing,
    # coverage never resets).
    assert st1["samples_traced"] > st0["samples_traced"]
    assert st1["covered"] >= st0["covered"]
    # Partial refresh per frame: the two snapshots differ where tiles
    # were re-traced under the new camera, and agree somewhere stale.
    diff = np.abs(img0 - img1).max(axis=-1)
    assert (diff > 1e-6).any()


import pytest


@pytest.mark.parametrize("depth", [2, 7])
def test_trimmed_prepare_is_output_invisible(depth):
    """`progressive_prepare_trimmed` drops only candidates that
    provably cannot win (occlusion bound + exact tile frustum); the
    accumulated buffer must be BIT-identical to the untrimmed table —
    on the shallow (7-row) AND deep (8-row, code_hi) fat-row layouts
    (the trim recovers |c| and r from the rc/rc4 rows by position)."""
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_prepare_trimmed,
        progressive_tiles_init,
        progressive_tiles_step,
    )

    scene = default_scene()
    cfg = RenderConfig(width=128, height=64, max_depth=depth, tile_h=32,
                       tile_w=32, algorithm="binned")
    T = cfg.tiles_y * cfg.tiles_x
    plain = progressive_prepare(scene, cfg)
    trimmed = progressive_prepare_trimmed(scene, cfg)
    n_plain = int(np.asarray(plain[2]).sum())
    n_trim = int(np.asarray(trimmed[2]).sum())
    assert 0 < n_trim <= n_plain

    st_a = progressive_tiles_init(cfg, seed=6)
    st_b = progressive_tiles_init(cfg, seed=6)
    for _ in range(2):
        st_a = progressive_tiles_step(st_a, scene, cfg, tiles_per_step=T,
                                      prepared=plain)
        st_b = progressive_tiles_step(st_b, scene, cfg, tiles_per_step=T,
                                      prepared=trimmed)
    np.testing.assert_array_equal(
        np.asarray(st_a.rows), np.asarray(st_b.rows)
    )


def test_overflow_is_accumulated_never_silent():
    """The project invariant (round-4 advisor finding): pair-table /
    compaction drops are COUNTED into the progressive state, step
    after step, so a capacity problem is visible to the driver (the
    CLI warns / retries the prepare via the capacity ladder) instead
    of silently rendering with missing geometry."""
    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
    )

    scene = default_scene()
    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    prepared = progressive_prepare(scene, cfg)

    # Healthy capacity: zero overflow after real steps.
    st = progressive_tiles_init(cfg, seed=2)
    for _ in range(2):
        st = progressive_tiles_step(st, scene, cfg, tiles_per_step=4,
                                    prepared=prepared)
    assert int(st.overflow) == 0
    assert int(prepared[3]) == 0

    # A prepare that dropped pairs must show up in the state, summed
    # across every step that consumed it.
    pairs, starts, lens, _ovf = prepared
    crowded = (pairs, starts, lens, jnp.int32(7))
    st = progressive_tiles_init(cfg, seed=2)
    for _ in range(3):
        st = progressive_tiles_step(st, scene, cfg, tiles_per_step=4,
                                    prepared=crowded)
    assert int(st.overflow) == 3 * 7

    # Same invariant on the per-SAMPLE path.
    st2 = progressive_init(cfg, seed=2)
    st2 = progressive_step(st2, scene, cfg, batch_size=1024,
                           prepared=crowded)
    st2 = progressive_step(st2, scene, cfg, batch_size=1024,
                           prepared=crowded)
    assert int(st2.overflow) == 2 * 7


def test_sobol_cursor_carries_into_hi_word_at_wrap():
    """Power-of-two step sizes land the 64-bit Sobol cursor exactly on
    the 2^32 boundary; the hi word must pick up the carry there or the
    stream restarts (a ~70-minute horizon at 1G rays/s)."""
    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
    )

    scene = default_scene()
    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    prepared = progressive_prepare(scene, cfg)

    st = progressive_tiles_init(cfg, seed=0)
    st = dataclasses.replace(st, sample_lo=jnp.uint32(2**32 - 4))
    st = progressive_tiles_step(st, scene, cfg, tiles_per_step=4,
                                prepared=prepared)
    assert int(st.sample_lo) == 0
    assert int(st.sample_hi) == 1

    st2 = progressive_init(cfg, seed=0)
    st2 = dataclasses.replace(st2, sample_lo=jnp.uint32(2**32 - 1024))
    st2 = progressive_step(st2, scene, cfg, batch_size=1024,
                           prepared=prepared)
    assert int(st2.sample_lo) == 0
    assert int(st2.sample_hi) == 1


def test_grow_frameless_capacity_ladder():
    """The frameless ladder doubles global_cap and ends with a clean
    error at the ceiling (banding cannot shrink a frame-spanning pair
    table, so spinning into the banded rung would be futile)."""
    import pytest

    from sphereflake.config import RenderConfig
    from sphereflake.runtime.progressive import (
        grow_frameless_capacity,
    )

    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    c2 = grow_frameless_capacity(cfg)
    assert c2.global_cap == cfg.global_cap * 2
    top = dataclasses.replace(cfg, global_cap=9 << 16)
    with pytest.raises(RuntimeError, match="capacity ceiling"):
        grow_frameless_capacity(top)


def test_frameless_approach_holds_position_on_all_sky_frames():
    """The approach speed law steps by the closest distance seen in the
    frame's refreshed tiles; an all-sky frame leaves that metric at
    _BIG and must NOT fling the camera (3e38 * 0.05 ~ f32 overflow) —
    the camera coasts on the last known value, or holds still if
    nothing was ever hit."""
    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.runtime.animate import frameless_animate

    scene = default_scene()
    # Look AWAY from the fractal: every refreshed tile is sky.
    cam = dataclasses.replace(
        scene.camera, yaw=scene.camera.yaw + float(np.pi)
    )
    scene = dataclasses.replace(scene, camera=cam)
    cfg = RenderConfig(width=128, height=64, max_depth=2, tile_h=32,
                       tile_w=32, algorithm="binned")
    frames = list(frameless_animate(
        scene, cfg, n_frames=2, steps_per_frame=1, tiles_per_step=2,
        mode="approach", composite=False,
    ))
    assert len(frames) == 2
    p0 = np.asarray(frames[0][1].camera.position)
    p1 = np.asarray(frames[1][1].camera.position)
    assert np.isfinite(p1).all()
    np.testing.assert_array_equal(p0, p1)
