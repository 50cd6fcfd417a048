"""Command-line entry point — the app shell.

Mirrors the reference's CLI surface (`--width/--height`,
`CommandLine.h:14-74`, `main.cpp:370-380`) and extends it with the knobs
the reference hardcodes (camera pose `main.cpp:93-96`, depth/LOD
`SIMD_AVX.h:25`, SSAO tuning `SSAO.cpp:49-55`). Headless: frames go to
PNG/NPZ instead of a GLFW window; the 1 Hz title-bar metrics line
(`main.cpp:271-294`) becomes a printed metrics line per frame.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sphereflake",
        description="differentiable sphereflake raytracer (JAX)",
    )
    p.add_argument("--width", type=int, default=1280)  # main.cpp:49
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--depth", type=int, default=4, help="max fractal level")
    p.add_argument("--lod", type=float, default=70.0, help="LOD factor (ref: 70 AVX / 60 SSE)")
    p.add_argument(
        "--algorithm",
        choices=("auto", "binned", "fast", "strict", "loose"),
        default="auto",
        help="traversal implementation; auto = the binned production "
        "path (global expansion + screen binning + trace kernel) on a "
        "GPU, the XLA fast path on the CPU",
    )
    p.add_argument("--tile", type=str, default=None,
                   help="tile HxW (default: 32x32 for binned, "
                   "64x128 otherwise)")
    p.add_argument("--max-frontier", type=int, default=1024)
    p.add_argument("--global-cap", type=int, default=None,
                   help="binned path: live-node cap per fractal level "
                   "(default: RenderConfig's 9*8192; doubled on overflow)")
    p.add_argument("--tile-batch", type=int, default=16)
    p.add_argument("--output", "-o", type=str, default="sphereflake.png")
    p.add_argument("--gbuffer", type=str, default=None, help="also save G-buffer NPZ")
    p.add_argument(
        "--mode",
        choices=("composite", "normals", "ao"),
        default="composite",
        help="composite = full SSAO pipeline; normals/ao = debug planes",
    )
    # camera pose (defaults = reference startup pose, main.cpp:93-96)
    p.add_argument("--camera-pos", type=str, default="-5.4098,-7.2139,1.19006")
    p.add_argument("--yaw", type=float, default=0.921999)
    p.add_argument("--pitch", type=float, default=-1.371)
    p.add_argument("--roll", type=float, default=0.0)
    p.add_argument("--fov", type=float, default=60.0)
    # frameless progressive mode (reference default behavior)
    p.add_argument("--progressive", type=int, default=0, metavar="STEPS",
                   help="frameless Sobol accumulation for N steps instead of a full frame")
    p.add_argument("--batch", type=int, default=65536, help="samples per progressive step")
    p.add_argument("--progressive-unit", choices=("tile", "sample"),
                   default="tile",
                   help="frameless refresh granularity: 'tile' traces "
                   "whole Sobol-chosen 1024-ray tiles through the trace "
                   "kernel (dense block writes); 'sample' scatters "
                   "individual Sobol pixels like the reference's packets "
                   "(reference semantics, a sort and scatter per sample)")
    p.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                   help="frameless mode: write a snapshot of the "
                   "in-flight buffer every K steps (with --mode "
                   "composite the full SSAO->blur->composite chain "
                   "runs over it, like the reference's display loop "
                   "every vsync, main.cpp:301-335); snapshots are "
                   "dispatched async and fetched while later steps "
                   "run, so accumulation never stalls on them")
    p.add_argument("--no-trim-prepared", action="store_true",
                   help="frameless mode: keep the full candidate table "
                   "instead of the occlusion/frustum-trimmed one (the "
                   "trim renders one frame at prepare time and drops "
                   "~35%% of candidates PROVABLY unable to win any "
                   "pixel — output is bit-identical; disable only to "
                   "skip the prepare-time render)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=1, help="frames to render (timing)")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    # Multi-device operation: like the reference's hardware_concurrency
    # worker pool (`Sphereflake.cpp:69`), the one executable uses every
    # available chip by default, sharding the screen over a 2D mesh.
    p.add_argument("--devices", type=int, default=None,
                   help="local devices to use (default: all; 1 disables "
                   "sharding)")
    p.add_argument("--mesh", type=str, default=None, metavar="RxC",
                   help="explicit 2D device mesh shape (rows x cols of "
                   "screen blocks; default: auto factorization)")
    p.add_argument("--loose-lod", action="store_true",
                   help="node-level LOD gating (faster, packet-like semantics)")
    # gradient-descent fitting (BASELINE config 4)
    p.add_argument("--fit", type=str, default=None, metavar="TARGET_NPZ",
                   help="fit scene params to a target G-buffer NPZ "
                   "(from --gbuffer) instead of rendering")
    p.add_argument("--fit-steps", type=int, default=100)
    p.add_argument("--fit-lr", type=float, default=2e-3)
    p.add_argument("--fit-params", choices=("camera", "ssao", "all"),
                   default="camera")
    p.add_argument("--fit-loss", choices=("gbuffer", "image"),
                   default="gbuffer",
                   help="'image' fits against the target NPZ's "
                   "composited frame through the FULL post chain "
                   "(SSAO/blur/composite) — required to put gradient "
                   "on --fit-params ssao; save targets with --gbuffer "
                   "in --mode composite")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="save fitted params/opt state (or progressive "
                   "state) to this NPZ")
    p.add_argument("--resume", type=str, default=None,
                   help="resume fit/progressive state from a checkpoint NPZ")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the timed frames")
    # camera-path animation (the reference's navigation, main.cpp:206-257)
    p.add_argument("--animate", type=int, default=0, metavar="FRAMES",
                   help="render a camera-path frame sequence")
    p.add_argument("--animate-mode", choices=("orbit", "approach"),
                   default="orbit")
    p.add_argument("--speed-factor", type=float, default=0.05,
                   help="approach step as a fraction of the closest-sphere "
                   "distance (the reference's speed law, main.cpp:213)")
    p.add_argument("--frameless", action="store_true",
                   help="animate with FRAMELESS accumulation: the "
                   "camera moves while tiles keep refreshing into one "
                   "persistent buffer (stale tiles from the previous "
                   "view get overwritten — the reference's SetView "
                   "mid-flight, main.cpp:304); --batch sets tiles "
                   "refreshed per camera step")
    p.add_argument("--frame-parallel", action="store_true",
                   help="animate (orbit) with FRAME data parallelism: "
                   "each device renders a different full frame per "
                   "dispatch — the efficient fleet shape for small "
                   "frames (tile-sharding one small frame is "
                   "fixed-cost-limited)")
    return p


def _auto_mesh_shape(n: int, cfg) -> tuple[int, int]:
    """Pick a (rows, cols) factorization of <= n devices that wastes
    the least padding for this frame (blocks are tile-aligned,
    ceil-divided — `parallel.sharded._block_cfg`), preferring square-ish
    meshes on ties. Every factorization works; this is just the
    cheapest one."""
    best = (1, 1)
    best_cost = None
    for my in range(1, n + 1):
        mx = n // my
        if mx < 1:
            continue
        bh = -(-cfg.height // (my * cfg.tile_h)) * cfg.tile_h
        bw = -(-cfg.width // (mx * cfg.tile_w)) * cfg.tile_w
        cost = (my * bh * mx * bw, abs(my - mx))
        if best_cost is None or cost < best_cost:
            best_cost, best = cost, (my, mx)
    return best


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from sphereflake.backend import default_algorithm, setup_compile_cache

    # A cache already configured by the embedding process (the test
    # suite, chip_smoke.py) is kept.
    if not jax.config.jax_compilation_cache_dir:
        setup_compile_cache()

    from sphereflake.config import (
        CameraParams,
        FractalParams,
        RenderConfig,
        SSAOParams,
        SceneParams,
    )
    from sphereflake.render import render_frame, render_gbuffer
    from sphereflake.utils.image import (
        shade_normals,
        write_gbuffer_npz,
        write_png,
    )

    algorithm = args.algorithm
    if algorithm == "auto":
        # The one executable always runs its fastest code (the
        # reference compiles-in AVX the same way, main.cpp:62-68).
        algorithm = default_algorithm()
    tile = args.tile or ("32x32" if algorithm == "binned" else "64x128")
    tile_h, tile_w = (int(v) for v in tile.split("x"))
    try:
        cfg = RenderConfig(
            width=args.width,
            height=args.height,
            max_depth=args.depth,
            lod_factor=args.lod,
            tile_h=tile_h,
            tile_w=tile_w,
            max_frontier=args.max_frontier,
            tile_batch=args.tile_batch,
            algorithm=algorithm,
            strict_lod=not args.loose_lod,
            **(
                {"global_cap": args.global_cap}
                if args.global_cap is not None
                else {}
            ),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # Device mesh: auto-shard over every local device (the reference
    # spawns hardware_concurrency() workers, `Sphereflake.cpp:67-74`);
    # --devices 1 opts out, --mesh RxC pins the factorization.
    mesh = None
    n_avail = len(jax.devices())
    if args.mesh is not None:
        try:
            my, mx = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            print(
                f"error: --mesh {args.mesh!r} is not of the form RxC "
                "(e.g. 2x4)", file=sys.stderr,
            )
            return 2
        if my < 1 or mx < 1:
            print(
                f"error: --mesh {args.mesh} must have positive dims",
                file=sys.stderr,
            )
            return 2
        if my * mx > n_avail:
            print(
                f"error: --mesh {args.mesh} needs {my * mx} devices, "
                f"have {n_avail}", file=sys.stderr,
            )
            return 2
    else:
        n = min(args.devices or n_avail, n_avail)
        my, mx = _auto_mesh_shape(n, cfg)
    if my * mx > 1:
        import numpy as _np
        from jax.sharding import Mesh

        mesh = Mesh(
            _np.asarray(jax.devices()[: my * mx]).reshape(my, mx),
            ("ty", "tx"),
        )

    if mesh is not None:
        from sphereflake.parallel.sharded import (
            render_frame_sharded,
            render_gbuffer_sharded,
        )

        render_frame_ = lambda s, c: render_frame_sharded(s, c, mesh)
        render_gbuffer_ = lambda s, c: render_gbuffer_sharded(s, c, mesh)
    else:
        render_frame_, render_gbuffer_ = render_frame, render_gbuffer

    pos = [float(v) for v in args.camera_pos.split(",")]
    scene = SceneParams(
        camera=CameraParams(
            position=jnp.asarray(pos, jnp.float32),
            yaw=jnp.float32(args.yaw),
            pitch=jnp.float32(args.pitch),
            roll=jnp.float32(args.roll),
            fov=jnp.float32(args.fov),
        ),
        fractal=FractalParams.reference_default(),
        ssao=SSAOParams.reference_default(),
    )

    mesh_str = (
        f" mesh={mesh.devices.shape[0]}x{mesh.devices.shape[1]}"
        if mesh is not None
        else ""
    )
    print(
        f"sphereflake: {cfg.width}x{cfg.height} depth={cfg.max_depth} "
        f"lod={cfg.lod_factor} tiles={cfg.tiles_y}x{cfg.tiles_x} "
        f"device={jax.devices()[0].platform} x{n_avail}{mesh_str}"
    )

    if args.animate:
        from sphereflake.runtime.animate import (
            animate,
            animate_frames_dp,
            frameless_animate,
        )

        if args.frameless:
            if cfg.algorithm != "binned":
                print("error: --frameless needs the binned path "
                      "(a GPU, or --algorithm binned)", file=sys.stderr)
                return 2
            steps_per_frame = 8
            tiles_per_step = max(1, args.batch // 1024 // steps_per_frame)
            stem, ext = os.path.splitext(args.output)
            ext = ext or ".png"
            t0 = time.perf_counter()
            n_rays = 0
            frames_it = frameless_animate(
                scene, cfg, args.animate,
                steps_per_frame=steps_per_frame,
                tiles_per_step=tiles_per_step,
                mode=args.animate_mode,
                speed_factor=args.speed_factor,
                seed=args.seed,
                composite=args.mode == "composite",
            )
            for i, (image, _sc, stats) in enumerate(frames_it):
                write_png(f"{stem}_{i:04d}{ext}", image)
                if i == 0:
                    t0 = time.perf_counter()  # after compile
                else:
                    n_rays += steps_per_frame * tiles_per_step * 1024
                print(
                    f"frameless frame {i}: closest "
                    f"{stats['closest']:.4f}, buffer covered "
                    f"{stats['covered'] * 100:.0f}%, refresh/frame "
                    f"{stats['refresh_fraction'] * 100:.0f}%"
                )
            dt = time.perf_counter() - t0
            if n_rays:
                print(
                    f"frameless animate: steady-state "
                    f"{n_rays / max(dt, 1e-9) / 1e6:.1f}M rays/s "
                    f"(re-binned per camera step, snapshots included)"
                )
            return 0
        if args.frame_parallel:
            if args.animate_mode != "orbit":
                print("error: --frame-parallel needs --animate-mode "
                      "orbit (approach is sequentially dependent via "
                      "the speed law)", file=sys.stderr)
                return 2
            frames_iter = animate_frames_dp(
                scene, cfg, args.animate, jax.devices()
            )
        else:
            frames_iter = animate(
                scene, cfg, args.animate, mode=args.animate_mode,
                speed_factor=args.speed_factor,
                composite=args.mode == "composite",
                mesh=mesh,
            )
        stem, ext = os.path.splitext(args.output)
        ext = ext or ".png"
        t0 = time.perf_counter()
        for i, (image, _) in enumerate(frames_iter):
            write_png(f"{stem}_{i:04d}{ext}", image)
        dt = time.perf_counter() - t0
        print(
            f"animate: {args.animate} frames ({args.animate_mode}) in "
            f"{dt:.1f}s -> {stem}_0000{ext}..{stem}_{args.animate - 1:04d}{ext}"
        )
        return 0

    if args.fit:
        import optax

        from sphereflake.fit import camera_only, fit, ssao_only
        from sphereflake.runtime.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        data = np.load(args.fit)
        tgt_pos = jnp.asarray(data["position"])
        tgt_nrm = jnp.asarray(data["normal"])
        tgt_img = None
        if args.fit_loss == "image":
            if "image" not in data:
                print(
                    f"error: {args.fit} has no 'image' plane — save the "
                    "target with --gbuffer in --mode composite",
                    file=sys.stderr,
                )
                return 2
            tgt_img = jnp.asarray(data["image"])
        if args.fit_params == "ssao" and args.fit_loss != "image":
            print(
                "error: --fit-params ssao needs --fit-loss image (the "
                "G-buffer carries no SSAO signal)", file=sys.stderr,
            )
            return 2
        opt = optax.adam(
            optax.cosine_decay_schedule(args.fit_lr, args.fit_steps)
        )
        opt_state = None
        if args.resume:
            loaded = load_checkpoint(
                args.resume, {"scene": scene, "opt_state": opt.init(scene)}
            )
            scene, opt_state = loaded["scene"], loaded["opt_state"]
        filters = {"camera": camera_only, "ssao": ssao_only}
        res = fit(
            scene, tgt_pos, tgt_nrm, cfg,
            steps=args.fit_steps, optimizer=opt, opt_state=opt_state,
            mesh=mesh,
            param_filter=filters.get(args.fit_params),
            log_every=max(1, args.fit_steps // 10),
            loss=args.fit_loss, target_image=tgt_img,
        )
        print(
            f"fit: loss {res.losses[0]:.6f} -> best "
            f"{min(res.losses):.6f} over {args.fit_steps} steps"
        )
        if args.checkpoint:
            save_checkpoint(
                args.checkpoint, scene=res.scene, opt_state=res.opt_state
            )
            print(f"wrote {args.checkpoint}")
        image, _ = render_frame_(res.scene, cfg)
        write_png(args.output, np.asarray(image))
        print(f"wrote {args.output}")
        return 0

    if args.progressive:
        from sphereflake.runtime.progressive import (
            progressive_init,
            progressive_prepare,
            progressive_step,
        )
        from sphereflake.runtime.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        use_tiles = (
            args.progressive_unit == "tile" and cfg.algorithm == "binned"
        )
        if args.snapshot_every and not use_tiles:
            print(
                "note: --snapshot-every only runs in the tile-granular "
                "frameless mode (binned algorithm, --progressive-unit "
                "tile); no in-flight snapshots will be written",
                file=sys.stderr,
            )
        # Static camera: bin the frame once, reuse across every step
        # (re-run progressive_prepare on camera change). A pair-table
        # overflow in the prepared table would silently drop geometry
        # from EVERY step, so grow capacity before accumulating — via
        # the FRAMELESS ladder, which ends cleanly at the global_cap
        # ceiling (banding, the full-frame ladder's next rung, cannot
        # help a pair table that spans the frame).
        from sphereflake.runtime.progressive import (
            grow_frameless_capacity,
            progressive_prepare_trimmed,
        )

        prep_fn = (
            progressive_prepare
            if (args.no_trim_prepared or args.progressive_unit != "tile")
            else progressive_prepare_trimmed
        )
        prepared = None
        if cfg.algorithm == "binned":
            while True:
                prepared = prep_fn(scene, cfg)
                if not int(prepared[3]):
                    break
                try:
                    cfg = grow_frameless_capacity(cfg)
                except RuntimeError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
                print(
                    f"pair-table overflow ({int(prepared[3])} pairs "
                    f"dropped) in frameless prepare; retrying with "
                    f"global_cap={cfg.global_cap}",
                    file=sys.stderr,
                )
        if use_tiles:
            from sphereflake.runtime.progressive import (
                progressive_tiles_init,
                progressive_tiles_step,
                tile_progressive_composite,
                tile_progressive_gbuffer,
            )

            stem, ext = os.path.splitext(args.output)
            ext = ext or ".png"

            def snapshot_image(st):
                # The display read of the frameless loop: the full post
                # chain over the in-flight buffer (composite mode,
                # `main.cpp:301-335`) or the debug normal shading.
                if args.mode == "composite":
                    return tile_progressive_composite(st, scene, cfg)
                _p, nrm, _mt, hit = tile_progressive_gbuffer(st, cfg)
                return None, (nrm, hit)  # shaded host-side at fetch

            def fetch_snapshot(path, img):
                if isinstance(img, tuple) and img[0] is None:
                    out = shade_normals(
                        np.asarray(img[1][0]), np.asarray(img[1][1])
                    )
                else:
                    out = np.asarray(img)
                write_png(path, out)

            tiles_per_step = max(1, args.batch // 1024)
            # Multi-device: all devices refine ONE frameless buffer,
            # each refreshing Sobol-chosen tiles of its own block —
            # the reference's worker pool sharing one G-buffer
            # (`Sphereflake.cpp:67-74`).
            frameless_mesh = None
            if mesh is not None:
                from sphereflake.parallel.frameless import (
                    _block_tiles,
                    sharded_tiles_as_single,
                    sharded_tiles_init,
                    sharded_tiles_step,
                )

                try:
                    _block_tiles(cfg, mesh)
                    frameless_mesh = mesh
                except ValueError as e:
                    print(
                        f"note: frameless runs single-device ({e})",
                        file=sys.stderr,
                    )
            if frameless_mesh is not None:
                n_dev = mesh.devices.size
                tiles_per_device = max(1, tiles_per_step // n_dev)

                def make_state():
                    return sharded_tiles_init(
                        cfg, frameless_mesh, seed=args.seed
                    )

                def step_state(st):
                    return sharded_tiles_step(
                        st, scene, cfg, frameless_mesh,
                        tiles_per_device=tiles_per_device,
                        prepared=prepared,
                    )

                as_plain = sharded_tiles_as_single
                tiles_per_step = tiles_per_device * n_dev
                ckpt_key = "progressive_tiles_sharded"
            else:

                def make_state():
                    return progressive_tiles_init(cfg, seed=args.seed)

                def step_state(st):
                    return progressive_tiles_step(
                        st, scene, cfg, tiles_per_step=tiles_per_step,
                        prepared=prepared,
                    )

                as_plain = lambda st: st
                ckpt_key = "progressive_tiles"
            state = make_state()
            if args.resume:
                state = load_checkpoint(
                    args.resume, {ckpt_key: state}
                )[ckpt_key]
            pending = []  # dispatched snapshots not yet fetched
            t0 = time.perf_counter()
            for step in range(args.progressive):
                state = step_state(state)
                if step == 0:
                    jax.block_until_ready(state.rows)  # compile barrier
                    t0 = time.perf_counter()
                if args.snapshot_every and (
                    (step + 1) % args.snapshot_every == 0
                    and step + 1 < args.progressive
                ):
                    # Dispatch the snapshot now; fetch the PREVIOUS one
                    # so its post chain overlapped the steps since —
                    # the producer/consumer decoupling of the
                    # reference's tracer/display threads.
                    pending.append(
                        (f"{stem}_s{step + 1:05d}{ext}",
                         snapshot_image(as_plain(state)))
                    )
                    if len(pending) > 1:
                        fetch_snapshot(*pending.pop(0))
            jax.block_until_ready(state.rows)
            dt = time.perf_counter() - t0
            for item in pending:
                fetch_snapshot(*item)
            if args.snapshot_every:
                n_snaps = (args.progressive - 1) // args.snapshot_every
                print(
                    f"wrote {n_snaps} in-flight snapshots "
                    f"({stem}_sNNNNN{ext})"
                )
            rays = max(1, args.progressive - 1) * tiles_per_step * 1024
            position, normal, min_t, _hit = tile_progressive_gbuffer(
                as_plain(state), cfg
            )
            print(
                f"progressive[tile]: {int(state.samples_traced)} samples "
                f"({int(state.covered.sum())}/{cfg.tiles_y * cfg.tiles_x} "
                f"tiles covered), {rays / max(dt, 1e-9) / 1e6:.1f}M "
                f"rays/s, closest sphere: "
                f"{float(state.closest_distance):.4f}"
            )
            if int(state.overflow):
                print(
                    f"warning: {int(state.overflow)} pair/kernel drops "
                    "accumulated across steps — the image is missing "
                    "geometry (raise --global-cap)",
                    file=sys.stderr,
                )
        else:
            state = progressive_init(cfg, seed=args.seed)
            if args.resume:
                state = load_checkpoint(args.resume, {"progressive": state})[
                    "progressive"
                ]
            t0 = time.perf_counter()
            for step in range(args.progressive):
                state = progressive_step(
                    state, scene, cfg, batch_size=args.batch,
                    prepared=prepared,
                )
                if step == 0:
                    jax.block_until_ready(state.position)  # compile barrier
                    t0 = time.perf_counter()
            jax.block_until_ready(state.position)
            dt = time.perf_counter() - t0
            steps_timed = max(1, args.progressive - 1)
            rays = steps_timed * args.batch
            position, normal, min_t = (
                state.position, state.normal, state.min_t
            )
            print(
                f"progressive: {int(state.samples_traced)} samples, "
                f"{rays / max(dt, 1e-9) / 1e6:.1f}M rays/s, "
                f"closest sphere: {float(state.closest_distance):.4f}"
            )
            if int(state.overflow):
                print(
                    f"warning: {int(state.overflow)} dropped nodes "
                    "accumulated across steps — the image is missing "
                    "geometry (raise --max-frontier / --global-cap)",
                    file=sys.stderr,
                )
        if args.mode == "composite":
            # The full reference display pipeline over the final
            # accumulated buffer (`main.cpp:301-335`); at full coverage
            # this equals `render_frame` of the same scene.
            if use_tiles:
                img = np.asarray(
                    tile_progressive_composite(as_plain(state), scene, cfg)
                )
            else:
                from sphereflake.ops.noise import ssao_noise_texture
                from sphereflake.ops.post import postprocess

                img = np.asarray(
                    postprocess(
                        position, normal, jnp.min(min_t), scene, cfg,
                        jnp.asarray(ssao_noise_texture(cfg.noise_size)),
                    )
                )
        else:
            img = shade_normals(normal)
        write_png(args.output, img)
        if args.gbuffer:
            # In composite mode the NPZ carries the composited frame
            # too, so a progressive run's target works with
            # `--fit-loss image` exactly like a full-frame one.
            write_gbuffer_npz(
                args.gbuffer, position, normal, min_t,
                image=img if args.mode == "composite" else None,
            )
        if args.checkpoint:
            key = ckpt_key if use_tiles else "progressive"
            save_checkpoint(args.checkpoint, **{key: state})
            print(f"wrote {args.checkpoint}")
        print(f"wrote {args.output}")
        return 0

    import contextlib

    profile_ctx = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )

    def one_frame(i):
        # Vary an inconsequential input so timed frames cannot be cached.
        import dataclasses as _dc

        cam = _dc.replace(scene.camera, yaw=scene.camera.yaw + 1e-7 * i)
        sc = _dc.replace(scene, camera=cam)
        if args.mode == "composite":
            return render_frame_(sc, cfg)
        return None, render_gbuffer_(sc, cfg)

    image, gb = one_frame(0)
    jax.block_until_ready(gb.min_t)  # compile barrier
    # Dispatch the timed frames back-to-back and block once: per-call
    # host<->device latency amortizes away, like the reference's
    # frameless pipeline never stalling on the GL thread.
    with profile_ctx:
        t0 = time.perf_counter()
        keep = []
        for i in range(args.frames):
            image, gb = one_frame(1 + i)
            keep.append(gb.min_t[0, 0])
        jnp.stack(keep).sum().block_until_ready()
        dt_total = time.perf_counter() - t0

    # Frontier overflow means dropped geometry: retry with doubled
    # capacity until clean (capacity may cost speed, never correctness —
    # the reference's recursion visits every LOD-passing node,
    # `Sphereflake.h:165-172`).
    from sphereflake.render import grow_capacity

    retries = 0
    while int(gb.metrics.overflow) and retries < 6:
        # Capacity may cost speed, never correctness: grow global_cap
        # (binned) / max_frontier (per-tile), then fall back to bands.
        cfg = grow_capacity(cfg)
        print(
            f"capacity overflow ({int(gb.metrics.overflow)} nodes "
            f"dropped); retrying with global_cap={cfg.global_cap} "
            f"bands={cfg.effective_band_rows} "
            f"max_frontier={cfg.max_frontier}",
            file=sys.stderr,
        )
        image, gb = one_frame(0)
        jax.block_until_ready(gb.min_t)
        retries += 1

    m = gb.metrics
    dt = dt_total / args.frames
    rays = cfg.width * cfg.height
    # The reference's 1 Hz title line (main.cpp:271-294):
    print(
        f"FPS: {1.0 / max(dt, 1e-9):.1f} Depth: {int(m.max_depth_reached)} "
        f"Rays per second: {rays / max(dt, 1e-9) / 1e3:.0f}k "
        f"Closest sphere: {float(m.closest_distance):.4f}"
    )
    if int(m.overflow):
        print(f"warning: frontier overflow dropped {int(m.overflow)} nodes "
              f"(raise --max-frontier)", file=sys.stderr)

    if args.mode == "composite":
        out = np.asarray(image)
    elif args.mode == "normals":
        out = shade_normals(gb.normal, gb.hit)
    else:  # ao
        from sphereflake.ops.noise import ssao_noise_texture
        from sphereflake.ops.post import ssao_pass

        ao = ssao_pass(
            gb.position, gb.normal,
            jnp.asarray(ssao_noise_texture(cfg.noise_size)), scene.ssao,
            scene.ssao.radius_multiplier * m.closest_distance,
            cfg.height // cfg.ssao_downscale, cfg.width // cfg.ssao_downscale,
        )
        out = np.repeat(np.asarray(ao)[..., None], 3, axis=-1)

    write_png(args.output, out)
    if args.gbuffer:
        write_gbuffer_npz(
            args.gbuffer, gb.position, gb.normal, gb.min_t,
            image=image if args.mode == "composite" else None,
        )
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
