"""CLI driver tests: render / fit / progressive checkpoint round trips
(the app-shell surface, `main.cpp:363-385` + `CommandLine.h`)."""

import numpy as np

from sphereflake.cli import main


def _common(*extra):
    # --devices 1: these tests pin the single-device app surface; the
    # auto-mesh default (every local device, like the reference's
    # hardware_concurrency) is covered by the explicit multi-device
    # tests below — without the pin, every CLI test would compile an
    # 8-virtual-device shard_map program.
    return [
        "--width", "96", "--height", "64", "--depth", "2",
        "--algorithm", "fast", "--tile", "32x32", "--devices", "1",
        *extra,
    ]


def test_render_writes_png_and_gbuffer(tmp_path):
    out = tmp_path / "a.png"
    gbuf = tmp_path / "g.npz"
    rc = main(_common("--output", str(out), "--gbuffer", str(gbuf)))
    assert rc == 0
    assert out.stat().st_size > 0
    data = np.load(gbuf)
    assert data["position"].shape == (64, 96, 3)
    assert data["min_t"].shape == (64, 96)


def test_render_binned_algorithm(tmp_path):
    out = tmp_path / "p.png"
    rc = main(_common("--output", str(out))[:-4] + [
        "--algorithm", "binned", "--tile", "32x32", "--output", str(out),
    ])
    assert rc == 0
    assert out.stat().st_size > 0


def test_bad_tile_is_an_error(tmp_path):
    rc = main(_common("--output", str(tmp_path / "x.png"))[:-4] + [
        "--algorithm", "binned", "--tile", "64x128",
        "--output", str(tmp_path / "x.png"),
    ])
    assert rc == 2


def test_fit_subcommand_reduces_loss(tmp_path, capsys):
    gbuf = tmp_path / "g.npz"
    assert main(_common(
        "--output", str(tmp_path / "t.png"), "--gbuffer", str(gbuf)
    )) == 0
    rc = main(_common(
        "--yaw", "0.93",  # perturbed start (default pose is 0.921999)
        "--fit", str(gbuf), "--fit-steps", "8",
        "--output", str(tmp_path / "f.png"),
        "--checkpoint", str(tmp_path / "ck.npz"),
    ))
    assert rc == 0
    txt = capsys.readouterr().out
    line = [l for l in txt.splitlines() if l.startswith("fit: loss")][0]
    first = float(line.split()[2])
    best = float(line.split()[5])
    assert best < first
    assert (tmp_path / "ck.npz").stat().st_size > 0


def test_progressive_checkpoint_resume(tmp_path, capsys):
    ck = tmp_path / "prog.npz"
    assert main(_common(
        "--progressive", "3", "--batch", "1024",
        "--output", str(tmp_path / "p.png"), "--checkpoint", str(ck),
    )) == 0
    assert main(_common(
        "--progressive", "2", "--batch", "1024", "--resume", str(ck),
        "--output", str(tmp_path / "p2.png"),
    )) == 0
    txt = capsys.readouterr().out
    counts = [
        int(l.split()[1]) for l in txt.splitlines()
        if l.startswith("progressive:")
    ]
    assert counts == [3072, 5120]  # resumed run continues the cursor


def test_animate_orbit_and_approach(tmp_path):
    out = tmp_path / "anim.png"
    rc = main(_common(
        "--animate", "3", "--animate-mode", "orbit", "--mode", "normals",
        "--output", str(out),
    ))
    assert rc == 0
    frames = sorted(tmp_path.glob("anim_*.png"))
    assert len(frames) == 3
    # Orbit frames must actually differ (the camera moved).
    assert frames[0].read_bytes() != frames[1].read_bytes()

    rc = main(_common(
        "--animate", "2", "--animate-mode", "approach", "--mode", "normals",
        "--output", str(tmp_path / "dive.png"),
    ))
    assert rc == 0
    assert len(sorted(tmp_path.glob("dive_*.png"))) == 2


def test_look_at_origin_actually_aims_at_origin():
    """Regression: the orbit-mode aim solve had yaw/pitch swapped (the
    camera rotation is Rz(roll) Ry(pitch) Rx(yaw), the reference's GLM
    quirk) — verify the forward axis really hits the origin from
    arbitrary positions."""
    import jax.numpy as jnp
    import numpy as np

    from sphereflake.config import CameraParams
    from sphereflake.runtime.animate import (
        _look_at_origin,
        camera_forward,
    )

    for pos in ([5.0, 2.0, 3.0], [0.0, 0.0, 9.0], [-4.0, -7.0, 1.0],
                [1.0, 8.0, -2.0]):
        p = jnp.asarray(pos, jnp.float32)
        yaw, pitch = _look_at_origin(p)
        cam = CameraParams(position=p, yaw=yaw, pitch=pitch,
                           roll=jnp.float32(0.0), fov=jnp.float32(60.0))
        f = np.asarray(camera_forward(cam))
        want = -np.asarray(pos) / np.linalg.norm(pos)
        assert f @ want > 0.9999, (pos, f, want)


def test_capacity_ladder_progression():
    """grow_capacity must first raise global_cap (until every level-5
    parent fits the expansion gate), then shrink bands, and terminate
    rather than loop (verified to clear a mid-dive overflow pose at
    step 4 on CPU)."""
    import dataclasses

    import pytest

    from sphereflake.config import RenderConfig
    from sphereflake.render import grow_capacity

    cfg = RenderConfig(width=320, height=192, max_depth=6, tile_h=32,
                       tile_w=32, algorithm="binned")
    caps, bands = [], []
    for _ in range(4):
        cfg = grow_capacity(cfg)
        caps.append(cfg.global_cap)
        bands.append(cfg.effective_band_rows)
    assert caps == [9 << 14, 9 << 15, 9 << 16, 9 << 16]
    assert bands[-1] == 1  # fell back to banding after the cap limit
    with pytest.raises(RuntimeError):
        grow_capacity(grow_capacity(cfg))

    # per-tile paths grow max_frontier
    cfg_f = RenderConfig(width=128, height=64, max_depth=3, tile_h=32,
                         tile_w=64, max_frontier=256)
    assert grow_capacity(cfg_f).max_frontier == 512


def test_cli_multidevice_matches_single(tmp_path):
    """The shipped app auto-shards over every local device (the
    reference auto-uses every core, `Sphereflake.cpp:69`): under the
    8-virtual-device test mesh, the default invocation must render
    the SAME image as --devices 1, including through the composite
    post pipeline, and at dims that do not divide over the mesh
    (pad-and-crop blocks)."""
    import jax

    assert len(jax.devices()) == 8
    a, b = tmp_path / "multi.png", tmp_path / "single.png"
    args = ["--width", "160", "--height", "96", "--depth", "2",
            "--algorithm", "binned", "--tile", "32x32"]
    assert main(args + ["--output", str(a)]) == 0
    assert main(args + ["--devices", "1", "--output", str(b)]) == 0
    import numpy as _np
    from PIL import Image

    ia = _np.asarray(Image.open(a), dtype=_np.int16)
    ib = _np.asarray(Image.open(b), dtype=_np.int16)
    # 8-bit PNG quantization: tangent-graze interpret-mode flips may
    # touch a handful of silhouette pixels (see test_binned's banded
    # note); the images must agree essentially everywhere.
    frac_off = (_np.abs(ia - ib) > 1).any(axis=-1).mean()
    assert frac_off < 1e-3, f"{frac_off:.4%} of pixels differ"


def test_cli_mesh_flag(tmp_path):
    out = tmp_path / "m.png"
    rc = main(["--width", "128", "--height", "64", "--depth", "2",
               "--algorithm", "binned", "--tile", "32x32",
               "--mesh", "2x2", "--output", str(out)])
    assert rc == 0
    assert out.stat().st_size > 0


def test_progressive_tile_unit(tmp_path, capsys):
    """The frameless default: whole-tile refresh through the trace
    kernel (--progressive-unit tile, binned only)."""
    out = tmp_path / "pt.png"
    ck = tmp_path / "pt.npz"
    rc = main([
        "--width", "96", "--height", "64", "--depth", "2",
        "--algorithm", "binned", "--tile", "32x32", "--devices", "1",
        "--progressive", "4", "--batch", "2048",
        "--checkpoint", str(ck), "--output", str(out),
    ])
    assert rc == 0
    txt = capsys.readouterr().out
    line = [l for l in txt.splitlines() if l.startswith("progressive[tile]:")]
    assert line, txt
    assert out.stat().st_size > 0
    # resume continues coverage
    rc = main([
        "--width", "96", "--height", "64", "--depth", "2",
        "--algorithm", "binned", "--tile", "32x32", "--devices", "1",
        "--progressive", "2", "--batch", "2048", "--resume", str(ck),
        "--output", str(out),
    ])
    assert rc == 0


def test_animate_frame_parallel(tmp_path):
    """--frame-parallel orbit: each virtual device renders a different
    frame per dispatch; frames must exist and differ."""
    out = tmp_path / "fp.png"
    rc = main(["--width", "96", "--height", "64", "--depth", "2",
               "--algorithm", "binned", "--tile", "32x32",
               "--animate", "3", "--frame-parallel",
               "--output", str(out)])
    assert rc == 0
    frames = sorted(tmp_path.glob("fp_*.png"))
    assert len(frames) == 3
    assert frames[0].read_bytes() != frames[1].read_bytes()


def test_progressive_composite_snapshots(tmp_path):
    """--snapshot-every runs the full post chain over the in-flight
    buffer every K steps (the reference's display loop) and the final
    --mode composite output exists."""
    out = tmp_path / "c.png"
    rc = main([
        "--width", "96", "--height", "64", "--depth", "2",
        "--algorithm", "binned", "--tile", "32x32", "--devices", "1",
        "--progressive", "5", "--batch", "3072", "--mode", "composite",
        "--snapshot-every", "2", "--output", str(out),
    ])
    assert rc == 0
    assert out.stat().st_size > 0
    snaps = sorted(tmp_path.glob("c_s*.png"))
    assert [p.name for p in snaps] == ["c_s00002.png", "c_s00004.png"]
    assert all(p.stat().st_size > 0 for p in snaps)


def test_frameless_animate_cli(tmp_path):
    """--animate --frameless: the camera moves while the buffer keeps
    accumulating; one PNG per camera step."""
    out = tmp_path / "f.png"
    rc = main([
        "--width", "96", "--height", "64", "--depth", "2",
        "--algorithm", "binned", "--tile", "32x32", "--devices", "1",
        "--animate", "2", "--frameless", "--batch", "16384",
        "--mode", "normals", "--output", str(out),
    ])
    assert rc == 0
    for i in range(2):
        assert (tmp_path / f"f_{i:04d}.png").stat().st_size > 0


def test_mesh_flag_error_paths():
    """Round-4 advisor: malformed --mesh values get a friendly error
    (exit 2), not a traceback; degenerate dims are rejected."""
    for bad in ("2x", "axb", "2x2x2", "0x4", "2x-1"):
        rc = main([
            "--width", "64", "--height", "32", "--depth", "1",
            "--algorithm", "fast", "--tile", "32x32",
            "--mesh", bad, "--output", "/tmp/never.png",
        ])
        assert rc == 2, bad


def test_profile_writes_a_trace(tmp_path):
    """--profile DIR captures a jax.profiler trace of the timed frames
    (the framework's analogue of the reference's external VTune
    workflow, SURVEY §5) — the directory must exist and be non-empty
    after a render."""
    import os

    prof = tmp_path / "trace"
    out = tmp_path / "prof.png"
    rc = main(_common(
        "--output", str(out), "--frames", "2", "--profile", str(prof),
    ))
    assert rc == 0
    assert out.stat().st_size > 0
    found = []
    for root, _dirs, files in os.walk(prof):
        found += [os.path.join(root, f) for f in files]
    assert found, "profiler trace directory is empty"


def test_progressive_composite_gbuffer_carries_image_plane(tmp_path, capsys):
    """A progressive run saved with --gbuffer in --mode composite must
    include the composited frame in the NPZ — the target surface
    --fit-loss image directs users to produce — and asking for
    in-flight snapshots outside the tile-granular mode says so instead
    of silently writing nothing."""
    gbuf = tmp_path / "g.npz"
    out = tmp_path / "p.png"
    rc = main(_common(
        "--progressive", "3", "--batch", "2048",
        "--progressive-unit", "sample", "--snapshot-every", "2",
        "--mode", "composite",
        "--output", str(out), "--gbuffer", str(gbuf),
    ))
    assert rc == 0
    data = np.load(gbuf)
    assert "image" in data
    assert data["image"].shape == (64, 96, 3)
    err = capsys.readouterr().err
    assert "snapshot-every only runs" in err
