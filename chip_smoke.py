"""Smoke test of the main render path, compiled on NVIDIA GPUs.

    python3 chip_smoke.py           # one GPU: the phases below
    python3 chip_smoke.py --four    # four GPUs: the 2x2 mesh path only

Run from the repository root. One process drives every card (a second
JAX process would find the card's memory already reserved).

One GPU, each phase checked against its reference and tolerance:

1. device check (platform must be ``gpu``; the card's name and power
   limit from ``nvidia-smi``);
2. the CLI, in-process: 1280x720 depth-4 with the full post chain, and
   1920x1080 depth-6;
3. the trace kernel against the plain ``jnp`` trace at 1080p depth-6,
   full frame and a 1024-tile subset;
4. the binned render against the float64 golden tracer, 256x256
   depth-2;
5. the frameless gate: tile refresh to full coverage matches the full
   render; one per-sample progressive step, its 1024-ray bundles
   (the kernel's ray-input variant) checked against the plain trace;
6. ``jax.grad`` through the binned path against central finite
   differences (camera yaw, radius_ratio);
7. peak device memory.

``--four``: render_frame_sharded (shared-bin G-buffer + sharded post),
the sharded frameless refresh and one psum'd ``fit_step_sharded`` step
on a 2x2 mesh, each against the one-card result in this process.

Exits non-zero, printing no result line, when JAX finds no GPU or any
phase fails. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

_BIG = 1e38

# Kernel-vs-reference bounds (f32 on both sides, different op order):
HIT_AGREE = 0.999  # hit masks agree on >= 99.9% of pixels
T_TOL = 1e-4  # min_t / position rtol = atol ...
T_AGREE = 0.99  # ... on >= 99% of pixels hit by both,
TIE_GAP = 1e-2  # the rest near-ties (two spheres at ~equal t)
NRM_TOL = 1e-3  # normals of agreeing pixels


# Shapes: BASELINE.json configs 2 (720p depth-4, the reference's
# interactive default) and 3 (1080p depth-6); config 1 for the golden.
CLI_FRAMES = ((1280, 720, 4), (1920, 1080, 6))
FRAME = (1920, 1080, 6)
GOLDEN_FRAME = (256, 256, 2)
FIT_FRAME = (1280, 720, 4)
REFRESH_TILES = 1024  # tiles per frameless step (bench.py's step)


class PhaseError(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def compare_gbuffers(t_a, pos_a, nrm_a, t_b, pos_b, nrm_b) -> dict:
    """Compare two G-buffers (min_t [...], pos/nrm [..., 3]; min_t >=
    _BIG at sky) with the kernel-vs-reference bounds above. Raises
    PhaseError on a violation; returns the measured agreement."""
    t_a, t_b = np.asarray(t_a), np.asarray(t_b)
    pos_a, pos_b = np.asarray(pos_a), np.asarray(pos_b)
    nrm_a, nrm_b = np.asarray(nrm_a), np.asarray(nrm_b)
    ha, hb = t_a < _BIG, t_b < _BIG
    hit_agree = float((ha == hb).mean())
    check(hit_agree >= HIT_AGREE, f"hit masks agree on {hit_agree:.5f}")
    both = ha & hb
    check(both.any(), "no pixel hit by both")
    ta, tb = t_a[both], t_b[both]
    close = np.isclose(ta, tb, rtol=T_TOL, atol=T_TOL)
    t_agree = float(close.mean())
    check(t_agree >= T_AGREE, f"min_t agrees on {t_agree:.5f}")
    worst_tie = float(np.abs(ta - tb)[~close].max()) if (~close).any() else 0.0
    check(worst_tie < TIE_GAP, f"min_t disagreement {worst_tie:.3g}")
    pa, pb = pos_a[both][close], pos_b[both][close]
    check(
        np.allclose(pa, pb, rtol=T_TOL, atol=T_TOL),
        f"positions differ by {np.abs(pa - pb).max():.3g}",
    )
    nd = float(np.abs(nrm_a[both][close] - nrm_b[both][close]).max())
    check(nd <= NRM_TOL, f"normals differ by {nd:.3g}")
    for a in (t_a, pos_a, nrm_a):
        check(np.isfinite(a).all(), "non-finite values")
    return {"hit_agree": hit_agree, "t_agree": t_agree,
            "worst_tie": worst_tie, "normal_maxdiff": nd,
            "hit_fraction": float(ha.mean())}


def rows_gbuffer(rows):
    """[K, C, R] kernel rows -> (min_t, pos [.., 3], nrm [.., 3])."""
    rows = np.asarray(rows)
    return rows[:, 0], np.moveaxis(rows[:, -6:-3], 1, -1), np.moveaxis(
        rows[:, -3:], 1, -1
    )


def binned_cfg(frame):
    from sphereflake.config import RenderConfig

    w, h, d = frame
    return RenderConfig(width=w, height=h, max_depth=d, tile_h=32,
                        tile_w=32, algorithm="binned")


def phase_device(n: int) -> dict:
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"needs an NVIDIA GPU; JAX found {devs[0].platform!r}")
    check(len(devs) >= n, f"needs {n} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": n}


def phase_cli() -> dict:
    from sphereflake.cli import main

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for w, h, d in CLI_FRAMES:
            png, npz = f"{tmp}/f{d}.png", f"{tmp}/g{d}.npz"
            t0 = time.perf_counter()
            rc = main(["--width", str(w), "--height", str(h), "--depth",
                       str(d), "--frames", "3", "--output", png,
                       "--gbuffer", npz])
            check(rc == 0, f"cli {w}x{h} depth {d} exited {rc}")
            g = np.load(npz)
            check(g["image"].shape == (h, w, 3), "cli image shape")
            check(np.isfinite(g["image"]).all(), "cli image not finite")
            hit = float((g["min_t"] < _BIG).mean())
            check(0.05 < hit < 1.0, f"cli hit fraction {hit}")
            out[f"{w}x{h}_d{d}"] = {"hit_fraction": hit,
                                    "wall_s": time.perf_counter() - t0}
    return out


def _times_ms(fns, trials=7):
    """Interleaved timings (ms) of each zero-argument callable, each
    trial ended by block_until_ready, after one warm-up call each."""
    import jax

    for f in fns:
        jax.block_until_ready(f())
    ts = [[] for _ in fns]
    for _ in range(trials):
        for f, t in zip(fns, ts):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            t.append((time.perf_counter() - t0) * 1e3)
    return [{"median": float(np.median(t)), "min": min(t), "max": max(t)}
            for t in ts]


def phase_kernel() -> dict:
    """The Triton kernel against the plain trace: agreement, and both
    timed end to end — a full frame (expansion + binning + trace +
    untile) and a frameless refresh step of REFRESH_TILES tiles."""
    import jax
    import jax.numpy as jnp

    from sphereflake.config import default_scene
    from sphereflake.models.sphereflake import child_templates, root_frame
    from sphereflake.ops.binned import (
        binned_pairs,
        camera_vector,
        trace_pairs,
        trace_pairs_reference,
    )
    from sphereflake.render import _untile_rows
    from sphereflake.runtime.progressive import progressive_prepare

    cfg, scene = binned_cfg(FRAME), default_scene()
    pairs, starts, lens, ovf = progressive_prepare(scene, cfg)
    check(int(ovf) == 0, "pair overflow")
    cam = camera_vector(scene, cfg)
    T = cfg.tiles_x * cfg.tiles_y
    ids = (jnp.arange(REFRESH_TILES, dtype=jnp.int32) * 7) % T
    out = {}
    for name, kw in (("full_frame", {}),
                     ("subset", {"tile_ids": ids}),
                     ("subset_shade_only",
                      {"tile_ids": ids, "shade_only": True})):
        a = trace_pairs(pairs, starts, lens, cfg, cam=cam, **kw)
        b = trace_pairs_reference(pairs, starts, lens, cfg, cam=cam, **kw)
        out[name] = compare_gbuffers(*rows_gbuffer(a), *rows_gbuffer(b))
        if not kw.get("shade_only"):
            lo_a, lo_b = np.asarray(a[:, 1]), np.asarray(b[:, 1])
            out[name]["code_agree"] = float((lo_a == lo_b).mean())
            check(out[name]["code_agree"] >= T_AGREE, "path codes differ")

    def frame(trace):
        @jax.jit
        def f(s):
            root = root_frame(s.camera.position)
            p, st, ln, _ = binned_pairs(s, cfg, root,
                                        child_templates(s.fractal))
            rows = trace(p, st, ln, cfg, cam=camera_vector(s, cfg))
            return _untile_rows(rows, cfg)
        return lambda: f(scene)

    def refresh(trace):
        @jax.jit
        def f(state_rows):
            rows = trace(pairs, starts, lens, cfg, cam=cam, tile_ids=ids,
                         shade_only=True)
            return state_rows.at[ids].set(rows)
        state = jnp.zeros((T, 7, 1024), jnp.float32)
        return lambda: f(state)

    for name, make in (("full_frame_ms", frame), ("refresh_step_ms", refresh)):
        k, p = _times_ms([make(trace_pairs), make(trace_pairs_reference)])
        out[name] = {"triton_kernel": k, "plain_jnp": p}
    return out


def phase_golden() -> dict:
    from sphereflake.config import default_scene
    from sphereflake.models import golden
    from sphereflake.render import render_gbuffer

    cfg = binned_cfg(GOLDEN_FRAME)
    gb = render_gbuffer(default_scene(), cfg)
    ref = golden.golden_render_gbuffer(cfg.width, cfg.height,
                                       max_depth=cfg.max_depth)
    hit_g, hit_b = np.isfinite(ref.min_t), np.asarray(gb.hit)
    hit_agree = float((hit_g == hit_b).mean())
    check(hit_agree > 0.999, f"golden hit agreement {hit_agree}")
    both = hit_g & hit_b
    rel = np.abs(np.asarray(gb.min_t)[both] - ref.min_t[both])
    rel = rel / np.abs(ref.min_t[both])
    off = float((rel > 1e-4).mean())
    check(off < 2e-3, f"{off:.4%} of pixels off the golden by > 1e-4")
    cos = np.sum(np.asarray(gb.normal)[both] * ref.normal[both], axis=-1)
    cos_ok = float((cos > 0.999).mean())
    check(cos_ok > 0.99, f"golden normal agreement {cos_ok}")
    return {"precision": "f32 on the card vs float64 golden",
            "hit_agree": hit_agree, "rel_err_gt_1e-4": off,
            "median_rel_err": float(np.median(rel)), "normal_cos_ok": cos_ok}


def phase_frameless() -> dict:
    from sphereflake.config import default_scene
    from sphereflake.ops.binned import trace_pairs, trace_pairs_reference
    from sphereflake.render import render_gbuffer
    from sphereflake.runtime.progressive import (
        progressive_init,
        progressive_prepare,
        progressive_prepare_trimmed,
        progressive_step,
        progressive_tiles_init,
        progressive_tiles_step,
        sample_bundles,
        sample_pixels,
        tile_progressive_gbuffer,
    )

    cfg, scene = binned_cfg(FRAME), default_scene()
    T = cfg.tiles_x * cfg.tiles_y
    full = render_gbuffer(scene, cfg)
    mt_full = np.asarray(full.min_t)

    # Tile refresh (the production frameless mode) to full coverage.
    prepared = progressive_prepare_trimmed(scene, cfg)
    check(int(prepared[3]) == 0, "pair overflow in frameless prepare")
    st = progressive_tiles_init(cfg, seed=1)
    for _ in range(24):
        st = progressive_tiles_step(st, scene, cfg,
                                    tiles_per_step=REFRESH_TILES,
                                    prepared=prepared)
    covered = int(np.asarray(st.covered).sum())
    _pos, _nrm, mt_acc, _hit = tile_progressive_gbuffer(st, cfg)
    agree = float(np.isclose(np.asarray(mt_acc), mt_full, rtol=1e-4,
                             atol=1e-4).mean())
    check(covered == T, f"{covered}/{T} tiles covered")
    check(agree >= 0.999, f"frameless buffer matches on {agree:.5f}")

    # One per-sample step: Sobol pixels traced in 1024-ray bundles
    # (the kernel's ray-input variant), first against the plain trace
    # on the very same bundles, then through the step itself.
    batch = 65536
    prepared = progressive_prepare(scene, cfg)
    pairs, starts, lens, _ovf = prepared
    st0 = progressive_init(cfg, seed=2)
    px, py, _lo, _hi = sample_pixels(st0, cfg, batch)
    order, dirs, b_start, b_len = sample_bundles(scene, cfg, px, py,
                                                 starts, lens)
    a = trace_pairs(pairs, b_start, b_len, cfg, dirs=dirs)
    b = trace_pairs_reference(pairs, b_start, b_len, cfg, dirs=dirs)
    bundles = compare_gbuffers(*rows_gbuffer(a), *rows_gbuffer(b))
    ps = progressive_step(st0, scene, cfg, batch_size=batch,
                          prepared=prepared)
    check(int(ps.samples_traced) == batch, "per-sample count")
    # The step wrote each sampled pixel with its bundle's result. It
    # compiles the ray math into another program than the calls above,
    # so directions may differ by an ulp, which small spheres amplify:
    # the check is on hits and on t within the near-tie gap.
    mt_ps = np.asarray(ps.min_t)
    mt_a = np.empty(batch, np.float32)
    mt_a[np.asarray(order)] = np.asarray(a[:, 0]).reshape(-1)
    yi, xi = np.asarray(py, int), np.asarray(px, int)
    got = mt_ps[yi, xi]
    hit_agree = float(((got < _BIG) == (mt_a < _BIG)).mean())
    check(hit_agree >= HIT_AGREE, f"step hits agree on {hit_agree:.5f}")
    both = (got < _BIG) & (mt_a < _BIG)
    written = float((np.abs(got[both] - mt_a[both]) < TIE_GAP).mean())
    check(written >= T_AGREE, f"step wrote {written:.5f} of samples")
    hits = int((mt_ps < _BIG).sum())
    check(hits > batch // 100, "per-sample step hit too few pixels")
    return {"tiles_covered": covered, "frameless_agree": agree,
            "per_sample_bundles": bundles, "per_sample_written": written,
            "per_sample_hit_pixels": hits}


def phase_grad() -> dict:
    import jax
    import jax.numpy as jnp

    from sphereflake.camera import pixel_grid, ray_directions
    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.render import render_gbuffer

    cfg = RenderConfig(width=64, height=32, max_depth=2, tile_h=32,
                       tile_w=32, max_frontier=128, algorithm="binned")
    scene = default_scene()

    def perturb(param, x):
        if param == "yaw":
            cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + x)
            return dataclasses.replace(scene, camera=cam)
        fr = dataclasses.replace(
            scene.fractal, radius_ratio=scene.fractal.radius_ratio + x
        )
        return dataclasses.replace(scene, fractal=fr)

    gb0 = render_gbuffer(scene, cfg)
    xs, ys = pixel_grid(cfg.width, cfg.height)
    dirs = ray_directions(scene.camera, xs, ys, cfg.width, cfg.height)
    ndotd = np.abs(np.asarray(jnp.sum(gb0.normal * dirs, axis=-1)))
    h0 = np.asarray(gb0.hit)
    t0 = np.where(h0, np.asarray(gb0.min_t), 0.0)
    eps = 1e-3
    out = {}
    for param in ("yaw", "radius_ratio"):
        def plane(x, param=param):
            gb = render_gbuffer(perturb(param, x), cfg)
            return gb.position, gb.min_t, gb.hit

        pos_p, t_p, hit_p = jax.jit(plane)(eps)
        pos_m, t_m, hit_m = jax.jit(plane)(-eps)
        hp, hm = np.asarray(hit_p), np.asarray(hit_m)
        tp = np.where(hp, np.asarray(t_p), 0.0)
        tm = np.where(hm, np.asarray(t_m), 0.0)
        # Stable pixels: same winner across the FD stencil, not grazing
        # (the bounds of tests/test_grad.py).
        stable = (hp & hm & h0 & (np.abs(tp - tm) < 0.05)
                  & (np.abs(tp + tm - 2 * t0) < 1e-3) & (ndotd > 0.2))
        check(stable.sum() > 200, f"{param}: only {stable.sum()} stable")
        fd = (np.asarray(pos_p) - np.asarray(pos_m)) / (2 * eps)
        w = jnp.asarray(stable, jnp.float32)[..., None] * (
            1.0 + 0.1 * jnp.arange(3, dtype=jnp.float32)
        )

        def loss(x, param=param):
            gb = render_gbuffer(perturb(param, x), cfg)
            return jnp.sum(gb.position * w)

        g = float(jax.grad(loss)(jnp.float32(0.0)))
        g_fd = float(np.sum(fd * np.asarray(w)))
        rel = abs(g - g_fd) / max(abs(g_fd), 1e-6)
        check(rel <= 0.05, f"{param}: grad {g:.6g} vs FD {g_fd:.6g}")
        _, jvp = jax.jvp(lambda x, p=param: render_gbuffer(
            perturb(p, x), cfg).position, (jnp.float32(0.0),),
            (jnp.float32(1.0),))
        d, gj = fd[stable], np.asarray(jvp)[stable]
        ok = np.abs(gj - d) <= 0.05 * np.abs(d) + 0.1
        check(ok.all(), f"{param}: {int((~ok).sum())} pixel gradients off")
        out[param] = {"grad": g, "fd": g_fd, "rel_err": rel,
                      "stable_pixels": int(stable.sum()),
                      "pixel_maxabs_err": float(np.abs(gj - d).max())}
    return out


def phase_memory() -> dict:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    check(peak is not None, "no peak_bytes_in_use")
    return {"peak_bytes_in_use": int(peak)}


def phase_four() -> dict:
    """The 2x2 mesh path against one card, in this process."""
    import jax
    import jax.numpy as jnp

    from sphereflake.config import default_scene
    from sphereflake.parallel import (
        fit_step_sharded,
        make_mesh,
        render_frame_sharded,
    )
    from sphereflake.parallel.frameless import (
        sharded_tiles_as_single,
        sharded_tiles_init,
        sharded_tiles_step,
    )
    from sphereflake.parallel.shared_bin import shared_bin_supported
    from sphereflake.render import render_frame, render_gbuffer
    from sphereflake.runtime.progressive import (
        progressive_prepare,
        tile_progressive_gbuffer,
    )

    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    cfg, scene = binned_cfg(FRAME), default_scene()
    out = {}

    check(shared_bin_supported(cfg, mesh), "1080p takes the shared bin")
    img_s, gb_s = render_frame_sharded(scene, cfg, mesh)
    img_1, gb_1 = render_frame(scene, cfg)
    out["gbuffer"] = compare_gbuffers(
        gb_s.min_t, gb_s.position, gb_s.normal,
        gb_1.min_t, gb_1.position, gb_1.normal,
    )
    close = np.isclose(np.asarray(img_s), np.asarray(img_1), rtol=T_TOL,
                       atol=T_TOL).all(axis=-1)
    out["image_agree"] = float(close.mean())
    check(out["image_agree"] >= HIT_AGREE, "sharded image differs")

    prepared = progressive_prepare(scene, cfg)
    st = sharded_tiles_init(cfg, mesh, seed=1)
    for _ in range(16):
        st = sharded_tiles_step(st, scene, cfg, mesh,
                                tiles_per_device=REFRESH_TILES // 4,
                                prepared=prepared)
    single = sharded_tiles_as_single(st)
    _p, _n, mt, _h = tile_progressive_gbuffer(single, cfg)
    cov = np.kron(np.asarray(st.covered),
                  np.ones((cfg.tile_h, cfg.tile_w), bool))[
        : cfg.height, : cfg.width]
    agree = float((np.isclose(np.asarray(mt), np.asarray(gb_1.min_t),
                              rtol=T_TOL, atol=T_TOL) | ~cov).mean())
    out["frameless"] = {"covered_fraction": float(np.asarray(st.covered).mean()),
                        "agree": agree}
    check(cov.mean() > 0.5, "sharded frameless covered too little")
    check(agree >= HIT_AGREE, f"sharded frameless agrees on {agree:.5f}")

    fcfg = binned_cfg(FIT_FRAME)
    target = render_gbuffer(scene, fcfg)
    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.01)
    scene_p = dataclasses.replace(scene, camera=cam)
    loss_s, grads_s = fit_step_sharded(
        scene_p, target.position, target.normal, fcfg, mesh
    )

    def single_loss(s):
        gb = render_gbuffer(s, fcfg)
        return (jnp.sum((gb.position - target.position) ** 2)
                + jnp.sum((gb.normal - target.normal) ** 2)
                ) / (fcfg.width * fcfg.height)

    loss_1, grads_1 = jax.value_and_grad(single_loss)(scene_p)
    gy_s, gy_1 = float(grads_s.camera.yaw), float(grads_1.camera.yaw)
    out["fit_step"] = {"loss_sharded": float(loss_s),
                       "loss_single": float(loss_1),
                       "grad_yaw_sharded": gy_s, "grad_yaw_single": gy_1}
    check(np.isclose(float(loss_s), float(loss_1), rtol=1e-3),
          "sharded loss differs")
    check(np.isclose(gy_s, gy_1, rtol=2e-2, atol=1e-6),
          "psum'd gradient differs")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 2x2 mesh path on four GPUs")
    args = ap.parse_args(argv)
    n = 4 if args.four else 1

    import jax

    try:
        device = phase_device(n)
    except (PhaseError, subprocess.SubprocessError, OSError) as e:
        print(f"FAIL device: {e}", file=sys.stderr)
        return 1

    from sphereflake.backend import setup_compile_cache

    setup_compile_cache()
    phases = [("four_gpu_mesh", phase_four)] if args.four else [
        ("cli", phase_cli), ("kernel_vs_plain", phase_kernel),
        ("golden", phase_golden), ("frameless", phase_frameless),
        ("grad", phase_grad), ("memory", phase_memory),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except PhaseError as e:
            print(f"FAIL {name}: {e}", file=sys.stderr)
            return 1
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s "
              f"{json.dumps(res)}", flush=True)
    jax.clear_caches()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
