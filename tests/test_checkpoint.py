"""Checkpoint/resume tests: bit-identical continuation (SURVEY §5)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax

from sphereflake.config import RenderConfig, default_scene
from sphereflake.fit import fit
from sphereflake.render import render_gbuffer
from sphereflake.runtime.checkpoint import load_checkpoint, save_checkpoint
from sphereflake.runtime.progressive import (
    progressive_init,
    progressive_step,
)


def _cfg(**kw):
    base = dict(width=64, height=32, max_depth=2, tile_h=16, tile_w=64,
                max_frontier=128)
    base.update(kw)
    return RenderConfig(**base)


def test_progressive_resume_bit_identical(tmp_path):
    cfg = _cfg()
    scene = default_scene()
    path = str(tmp_path / "prog.npz")

    # Uninterrupted: 5 steps.
    s = progressive_init(cfg, seed=7)
    for _ in range(5):
        s = progressive_step(s, scene, cfg, batch_size=512)

    # Interrupted: 3 steps, save, load, 2 more steps.
    a = progressive_init(cfg, seed=7)
    for _ in range(3):
        a = progressive_step(a, scene, cfg, batch_size=512)
    save_checkpoint(path, progressive=a)
    b = load_checkpoint(
        path, {"progressive": progressive_init(cfg, seed=0)}
    )["progressive"]
    for _ in range(2):
        b = progressive_step(b, scene, cfg, batch_size=512)

    np.testing.assert_array_equal(np.asarray(s.position), np.asarray(b.position))
    np.testing.assert_array_equal(np.asarray(s.normal), np.asarray(b.normal))
    np.testing.assert_array_equal(np.asarray(s.min_t), np.asarray(b.min_t))
    assert int(s.sample_lo) == int(b.sample_lo)
    assert int(s.samples_traced) == int(b.samples_traced)


def test_fit_state_resume_identical(tmp_path):
    cfg = _cfg()
    scene = default_scene()
    target = render_gbuffer(scene, cfg)
    off = dataclasses.replace(
        scene, camera=dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + 0.02
        )
    )
    opt = optax.adam(1e-3)
    path = str(tmp_path / "fit.npz")

    # Uninterrupted: 6 steps (no best-tracking so the iterate is exact).
    r = fit(off, target.position, target.normal, cfg, steps=6,
            optimizer=opt, keep_best=False)

    # Interrupted at step 3.
    r1 = fit(off, target.position, target.normal, cfg, steps=3,
             optimizer=opt, keep_best=False)
    save_checkpoint(path, scene=r1.scene, opt_state=r1.opt_state)
    loaded = load_checkpoint(
        path, {"scene": off, "opt_state": opt.init(off)}
    )
    r2 = fit(loaded["scene"], target.position, target.normal, cfg, steps=3,
             optimizer=opt, opt_state=loaded["opt_state"], keep_best=False)

    import jax

    for a, b in zip(
        jax.tree_util.tree_leaves(r.scene),
        jax.tree_util.tree_leaves(r2.scene),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert r2.losses[0] < r.losses[0]  # it really did continue, not restart


def test_checkpoint_rejects_wrong_structure(tmp_path):
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, scene=default_scene())
    try:
        load_checkpoint(path, {"other": default_scene()})
    except KeyError:
        pass
    else:
        raise AssertionError("expected KeyError for missing component")
