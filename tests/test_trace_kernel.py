"""The trace kernel (`ops.binned.trace_pairs`), its plain reference
(`trace_pairs_reference`), the route that decides how the kernel runs
(`backend.kernel_route`), the compile-cache helper, and the entry
points that must refuse to run off the GPU.

On the CPU the Triton kernel runs in Pallas interpret mode (the same
kernel body), so frames here are tiny. Card-only checks are marked
`gpu` and skip here; `chip_smoke.py` runs them as phases on the card.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphereflake import backend
from sphereflake.config import RenderConfig, default_scene
from sphereflake.models.sphereflake import child_templates, root_frame
from sphereflake.ops.binned import (
    _BIG,
    binned_pairs,
    camera_vector,
    trace_pairs,
    trace_pairs_reference,
)
from sphereflake.ops.codes import TILE_RAYS
from sphereflake.render import _tile, render_gbuffer

REPO = Path(__file__).resolve().parent.parent


def _cfg(**kw):
    base = dict(
        width=64,
        height=32,
        max_depth=2,
        tile_h=32,
        tile_w=32,
        max_frontier=128,
        tile_batch=4,
    )
    base.update(kw)
    return RenderConfig(**base)


def _assert_rows_match(a, b):
    """Kernel rows vs reference rows: the bounds chip_smoke.py holds the
    compiled kernel to (hit masks, min_t/position, normals)."""
    import chip_smoke

    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    chip_smoke.compare_gbuffers(*chip_smoke.rows_gbuffer(a),
                                *chip_smoke.rows_gbuffer(b))
    if a.shape[1] > 7:  # code lanes
        np.testing.assert_array_equal(a[:, 1:-6], b[:, 1:-6])


# ---- the render through the kernel (interpret mode) -------------------


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_binned_render_matches_fast_path(depth):
    scene = default_scene()
    gp = render_gbuffer(scene, _cfg(max_depth=depth, algorithm="binned"))
    gf = render_gbuffer(scene, _cfg(max_depth=depth, algorithm="fast"))

    hit_p = np.asarray(gp.hit)
    hit_f = np.asarray(gf.hit)
    # Culls on both paths are conservative, so candidate sets match and
    # hit masks agree except at most isolated near-tie boundary lanes.
    assert (hit_p == hit_f).mean() > 0.999
    both = hit_p & hit_f
    tp = np.asarray(gp.min_t)[both]
    tf = np.asarray(gf.min_t)[both]
    agree = np.isclose(tp, tf, rtol=1e-4, atol=1e-4)
    assert agree.mean() > 0.99
    if not agree.all():
        # Disagreements must be near-ties (two spheres at ~equal t whose
        # winner flips under f32 op-order differences), not wrong hits.
        assert np.abs(tp[~agree] - tf[~agree]).max() < 1e-2
    np.testing.assert_allclose(
        np.asarray(gp.position)[both][agree],
        np.asarray(gf.position)[both][agree],
        rtol=1e-4,
        atol=1e-4,
    )
    # Normals divide by the winner radius (~0.1 at depth 2), amplifying
    # grazing-ray positional noise ~10x: near-total 1e-3 agreement, a
    # 1e-2 hard bound.
    nd = np.abs(
        np.asarray(gp.normal)[both][agree]
        - np.asarray(gf.normal)[both][agree]
    )
    assert (nd.max(axis=-1) < 1e-3).mean() > 0.98
    assert nd.max() < 1e-2


def test_binned_metrics_sane_small_frame():
    scene = default_scene()
    gb = render_gbuffer(scene, _cfg(algorithm="binned"))
    assert int(gb.metrics.max_depth_reached) >= 1
    assert int(gb.metrics.nodes_visited) > 0
    assert float(gb.metrics.closest_distance) > 0.0
    assert int(gb.metrics.rays_traced) == 64 * 32


def test_binned_camera_move_changes_image():
    scene = default_scene()
    cfg = _cfg(algorithm="binned")
    g1 = render_gbuffer(scene, cfg)
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.05)
    g2 = render_gbuffer(dataclasses.replace(scene, camera=cam), cfg)
    assert not np.allclose(np.asarray(g1.min_t), np.asarray(g2.min_t))


# ---- the kernel against the plain trace, flag by flag ------------------


def _table(depth):
    """A 3x2-tile frame's binned table: 6 tiles, not a multiple of
    anything the kernel could want padded to."""
    cfg = RenderConfig(width=96, height=64, max_depth=depth, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    root = root_frame(scene.camera.position)
    pairs, starts, lens, (_n, ovf) = binned_pairs(
        scene, cfg, root, child_templates(scene.fractal)
    )
    assert int(ovf) == 0
    return cfg, scene, pairs, starts, lens


def _tile_dirs(cfg, scene):
    """[T, 3, TILE_RAYS] ray directions of every tile, in the kernel's
    ray order (the same raygen math as `_camera_rays`)."""
    from sphereflake.camera import corner_rays

    origin, tl, tr, bl = corner_rays(scene.camera, cfg.width / cfg.height)
    ex, ey = tr - tl, bl - tl
    u = jnp.arange(cfg.padded_width, dtype=jnp.float32)[None, :] / cfg.width
    v = jnp.arange(cfg.padded_height, dtype=jnp.float32)[:, None] / cfg.height
    comps = [(tl[a] + (ex[a] * u + ey[a] * v)) - origin[a] for a in range(3)]
    dn = jnp.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
    return jnp.stack([_tile(c / dn, cfg) for c in comps], axis=1)


_MODES = {
    "frame": dict(),
    "frame_shade_only": dict(shade_only=True),
    "subset": dict(subset=True),
    "subset_shade_only": dict(subset=True, shade_only=True),
    "dirs": dict(dirs=True),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_kernel_matches_plain_trace(mode):
    opts = _MODES[mode]
    cfg, scene, pairs, starts, lens = _table(3)
    T = cfg.tiles_x * cfg.tiles_y
    kw = {"shade_only": opts.get("shade_only", False)}
    if opts.get("dirs"):
        kw["dirs"] = _tile_dirs(cfg, scene)
    else:
        kw["cam"] = camera_vector(scene, cfg)
    if opts.get("subset"):
        kw["tile_ids"] = jnp.asarray([4, 0, 4, 5, 1], jnp.int32)
    a = trace_pairs(pairs, starts, lens, cfg, **kw)
    b = trace_pairs_reference(pairs, starts, lens, cfg, **kw)
    n_rows = 7 if kw["shade_only"] else 8
    K = 5 if opts.get("subset") else T
    assert a.shape == (K, n_rows, TILE_RAYS)
    _assert_rows_match(a, b)
    assert (np.asarray(a[:, 0]) < _BIG).any()


@pytest.mark.parametrize("rays", ["cam", "dirs"])
def test_deep_kernel_matches_plain_trace(rays):
    """max_depth >= 7 carries the hi path-code lane (9 rows)."""
    cfg, scene, pairs, starts, lens = _table(7)
    kw = ({"cam": camera_vector(scene, cfg)} if rays == "cam"
          else {"dirs": _tile_dirs(cfg, scene)})
    a = trace_pairs(pairs, starts, lens, cfg, **kw)
    b = trace_pairs_reference(pairs, starts, lens, cfg, **kw)
    assert a.shape[1] == 9
    _assert_rows_match(a, b)


def test_dirs_input_equals_in_kernel_raygen():
    """Feeding each tile its own rays reproduces the raygen variant:
    the same winners, to the last few ulps of the ray directions (XLA
    and the kernel divide in another order; normals divide by the
    winner radius, so grazing pixels amplify that ~100x)."""
    cfg, scene, pairs, starts, lens = _table(2)
    a = np.asarray(trace_pairs(pairs, starts, lens, cfg,
                               cam=camera_vector(scene, cfg)))
    b = np.asarray(trace_pairs(pairs, starts, lens, cfg,
                               dirs=_tile_dirs(cfg, scene)))
    np.testing.assert_array_equal(a[:, 1], b[:, 1])  # path codes
    np.testing.assert_allclose(a[:, :5], b[:, :5], rtol=1e-4, atol=1e-4)
    nd = np.abs(a[:, 5:] - b[:, 5:]).max(axis=1)
    assert (nd < 1e-3).mean() > 0.99 and nd.max() < 1e-2


def test_empty_segments_are_sky():
    cfg, scene, pairs, starts, lens = _table(2)
    empty = lens.at[jnp.asarray([0, 3])].set(0)
    cam = camera_vector(scene, cfg)
    a = np.asarray(trace_pairs(pairs, starts, empty, cfg, cam=cam))
    b = np.asarray(trace_pairs_reference(pairs, starts, empty, cfg, cam=cam))
    for k in (0, 3):
        assert (a[k, 0] == _BIG).all()
        assert (a[k, 1:] == 0.0).all()
    _assert_rows_match(a, b)
    full = np.asarray(trace_pairs(pairs, starts, lens, cfg, cam=cam))
    np.testing.assert_array_equal(a[[1, 2, 4, 5]], full[[1, 2, 4, 5]])


def test_long_segments_loop_to_their_end():
    """A segment far longer than any staging window: the table repeated
    8 times back to back. Repeated candidates cannot change a minimum,
    so each tile's 8x segment traces exactly like its 1x segment, and
    a candidate placed only at the very end of a long segment still
    wins."""
    cfg, scene, pairs, starts, lens = _table(2)
    n = int(starts[-1] + lens[-1])
    reps = 8
    big = jnp.tile(pairs[:, :n], (1, reps))
    dirs = _tile_dirs(cfg, scene)
    # Bundle k = tile k's rays over [its segment] + (reps-1) copies of
    # the whole table after it.
    b_start = starts
    b_len = lens + (reps - 1) * n
    assert int(b_len.min()) > 512
    a = trace_pairs(big, b_start, b_len, cfg, dirs=dirs)
    ref = trace_pairs_reference(big, b_start, b_len, cfg, dirs=dirs)
    _assert_rows_match(a, ref)
    # Every tile now sees every candidate of the frame: the nearest hit
    # over the whole table, which the binning makes equal to the frame.
    one = trace_pairs(pairs, starts, lens, cfg, dirs=dirs)
    _assert_rows_match(a, one)


def test_wrapper_rejects_ambiguous_rays():
    cfg, scene, pairs, starts, lens = _table(2)
    cam = camera_vector(scene, cfg)
    dirs = _tile_dirs(cfg, scene)
    with pytest.raises(ValueError, match="exactly one"):
        trace_pairs(pairs, starts, lens, cfg)
    with pytest.raises(ValueError, match="exactly one"):
        trace_pairs(pairs, starts, lens, cfg, cam=cam, dirs=dirs)
    with pytest.raises(ValueError, match="tile_ids"):
        trace_pairs(pairs, starts, lens, cfg, dirs=dirs,
                    tile_ids=jnp.zeros((6,), jnp.int32))


# ---- the route and the cache ------------------------------------------


@pytest.mark.parametrize(
    "platform,route,algorithm",
    [("gpu", "triton", "binned"), ("cpu", "interpret", "fast")],
)
def test_kernel_route(platform, route, algorithm):
    assert backend.kernel_route(platform) == route
    assert backend.default_algorithm(platform) == algorithm


@pytest.mark.parametrize("platform", ["rocm", "metal", "sycl"])
def test_kernel_route_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no trace-kernel route"):
        backend.kernel_route(platform)
    with pytest.raises(RuntimeError):
        backend.default_algorithm(platform)


def test_kernel_route_defaults_to_this_process():
    assert backend.kernel_route() == "interpret"  # the suite runs on CPU


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(backend.setup_compile_cache())
    assert path == REPO / ".jax_cache" and path.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(path)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# ---- entry points that must refuse the CPU ----------------------------


def _run(cmd, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run([sys.executable, "chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run([sys.executable, "chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_without_gpu():
    r = _run([sys.executable, "bench.py"], REPO)
    assert r.returncode != 0
    assert "NVIDIA GPU" in r.stderr


# ---- card-only: compiled kernel (chip_smoke.py phases) ----------------


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_trace(gpu):
    import chip_smoke

    chip_smoke.phase_kernel()


@pytest.mark.gpu
def test_compiled_render_matches_golden(gpu):
    import chip_smoke

    chip_smoke.phase_golden()


@pytest.mark.gpu
def test_compiled_gradients_match_finite_differences(gpu):
    import chip_smoke

    chip_smoke.phase_grad()
