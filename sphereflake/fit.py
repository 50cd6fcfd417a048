"""Gradient-descent fitting of scene parameters to a target G-buffer.

BASELINE config 4: differentiate the renderer end-to-end and fit
camera pose / fractal / SSAO parameters by gradient descent against a
target. The loss surface is the G-buffer (position + normal planes) —
the same planes the reference's tracer produces (`Sphereflake.h:7-11`)
— so the gradients flow through ray generation (`camera.py`), the
traversal (any `cfg.algorithm`, including the Pallas production path
via its path-code recompute), and the analytic intersection.

Single-device and mesh-sharded (`parallel.fit_step_sharded`) drivers
share the same loss definition; the sharded path psum-all-reduces
parameter gradients over the tile mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from sphereflake.config import RenderConfig, SceneParams
from sphereflake.render import render_gbuffer

Array = Any


def gbuffer_loss(
    scene: SceneParams, target_pos: Array, target_nrm: Array, cfg: RenderConfig
):
    """Mean-squared G-buffer error (matches `parallel.fit_step_sharded`)."""
    gb = render_gbuffer(scene, cfg)
    n_pix = cfg.width * cfg.height
    err = jnp.sum((gb.position - target_pos) ** 2) + jnp.sum(
        (gb.normal - target_nrm) ** 2
    )
    return err / n_pix


def image_loss(scene: SceneParams, target_image: Array, cfg: RenderConfig):
    """Mean-squared COMPOSITE-image error: differentiates through the
    ENTIRE reference pipeline — trace, SSAO (incl. the radius law fed
    by the closest-distance metric, `main.cpp:316`), both blur passes,
    and the composite (`main.cpp:301-335`). This is the loss that puts
    gradient signal on `SSAOParams` (intensity/scale/bias,
    `SSAO.cpp:49-55`): the G-buffer loss never touches them."""
    from sphereflake.render import render_frame

    image, _gb = render_frame(scene, cfg)
    n_pix = cfg.width * cfg.height
    return jnp.sum((image - target_image) ** 2) / n_pix


@partial(jax.jit, static_argnames=("cfg",))
def fit_step(
    scene: SceneParams, target_pos: Array, target_nrm: Array, cfg: RenderConfig
):
    """(loss, grads) for one single-device step."""
    return jax.value_and_grad(gbuffer_loss)(scene, target_pos, target_nrm, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def fit_step_image(
    scene: SceneParams, target_image: Array, cfg: RenderConfig
):
    """(loss, grads) for one image-loss step (post chain included)."""
    return jax.value_and_grad(image_loss)(scene, target_image, cfg)


@dataclasses.dataclass
class FitResult:
    scene: SceneParams  # best-loss parameters seen (keep_best) or final
    opt_state: Any
    losses: list[float]


def fit(
    scene: SceneParams,
    target_pos: Array,
    target_nrm: Array,
    cfg: RenderConfig,
    steps: int = 100,
    learning_rate: float = 2e-3,
    optimizer: optax.GradientTransformation | None = None,
    opt_state: Any = None,
    mesh=None,
    param_filter: Callable[[SceneParams], SceneParams] | None = None,
    log_every: int = 0,
    keep_best: bool = True,
    loss: str = "gbuffer",
    target_image: Array | None = None,
) -> FitResult:
    """Run an optax fitting loop; returns the fitted scene + history.

    `param_filter` masks the gradient pytree (e.g. fit only the camera);
    `mesh` switches to the sharded step. Passing `opt_state` resumes a
    checkpointed run. With `keep_best` (default) the returned scene is
    the best-loss iterate — the G-buffer loss is only piecewise smooth
    (silhouette discontinuities), so the last Adam iterate can sit above
    the best one found. `loss="image"` fits against a target COMPOSITE
    image through the full post chain (`image_loss`) — required for
    SSAO-parameter fitting; pass `target_image` instead of the G-buffer
    planes.
    """
    optimizer = optimizer or optax.adam(learning_rate)
    if opt_state is None:
        opt_state = optimizer.init(scene)

    if loss == "image":
        assert target_image is not None, "loss='image' needs target_image"
        if mesh is not None:
            # The sharded pipeline produces the identical image
            # (tests/test_sharded.py); differentiate it directly.
            from sphereflake.parallel import render_frame_sharded

            @partial(jax.jit, static_argnames=())
            def step_fn(s):
                def f(s):
                    image, _gb = render_frame_sharded(s, cfg, mesh)
                    return (
                        jnp.sum((image - target_image) ** 2)
                        / (cfg.width * cfg.height)
                    )

                return jax.value_and_grad(f)(s)
        else:
            def step_fn(s):
                return fit_step_image(s, target_image, cfg)
    elif mesh is not None:
        from sphereflake.parallel import fit_step_sharded

        def step_fn(s):
            return fit_step_sharded(s, target_pos, target_nrm, cfg, mesh)
    else:
        def step_fn(s):
            return fit_step(s, target_pos, target_nrm, cfg)

    losses: list[float] = []
    best_scene, best_loss = scene, float("inf")
    for i in range(steps):
        loss, grads = step_fn(scene)
        if param_filter is not None:
            grads = param_filter(grads)
        losses.append(float(loss))
        if losses[-1] < best_loss:
            best_loss, best_scene = losses[-1], scene
        updates, opt_state = optimizer.update(grads, opt_state)
        scene = optax.apply_updates(scene, updates)
        if log_every and i % log_every == 0:
            print(f"fit step {i}: loss {losses[-1]:.6f}", flush=True)
    return FitResult(
        scene=best_scene if keep_best else scene,
        opt_state=opt_state,
        losses=losses,
    )


def camera_only(grads: SceneParams) -> SceneParams:
    """Gradient mask: optimize the camera pose only."""
    zero = jax.tree.map(jnp.zeros_like, grads)
    return dataclasses.replace(zero, camera=grads.camera)


def ssao_only(grads: SceneParams) -> SceneParams:
    """Gradient mask: optimize the SSAO parameters only (the
    reference's tuned uniforms, `SSAO.cpp:49-55`); pair with
    `loss="image"` — the G-buffer loss carries no SSAO signal."""
    zero = jax.tree.map(jnp.zeros_like, grads)
    return dataclasses.replace(zero, ssao=grads.ssao)
