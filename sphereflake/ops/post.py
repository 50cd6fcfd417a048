"""Post-processing: SSAO, edge-aware separable blur, final composite.

Pure-JAX, differentiable re-implementations of the reference's GLSL
passes, orchestrated the same way as `SSAO::Render()` (`SSAO.cpp:106-142`)
and the final pass of `main.cpp:301-335`:

    G-buffer -> SSAO (at size/downscale) -> horizontal blur -> vertical
    blur -> composite

Where the reference pipes intermediates through RGBA8 FBO textures
(`GLFramebufferObject.cpp:41`, quantizing AO to 8 bits), we keep f32 —
the one deliberate quality upgrade; everything else follows the shaders
tap-for-tap, including the near-identity behavior of the blur gate with
the shipped normalThreshold=2.47 (`post_ssao_blur.glsl:46-55`: a unit
normal dot can never reach it — mechanism preserved, quirk documented).
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from sphereflake.config import RenderConfig, SSAOParams, SceneParams
from sphereflake.ops.texture import (
    sample_bilinear_clamp,
    sample_bilinear_repeat,
    sample_nearest_clamp,
)

Array = Any

# post_ssao.glsl:15 — the 4 kernel directions. Kept as a NumPy constant:
# this module is imported lazily (possibly inside an active jit trace),
# where a module-level jnp constant would be built from tracers and leak.
import numpy as _np

_KERNEL = _np.asarray(
    [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], _np.float32
)
# post_ssao_blur.glsl:9-10 — 5-tap gaussian as center + 2 mirrored taps
_BLUR_OFFSET = (1.3846153846, 3.2307692308)
_BLUR_WEIGHT = (0.2270270270, 0.3162162162, 0.0702702703)


def _fragcoord(h: int, w: int):
    """gl_FragCoord.xy for every pixel of an h x w target: (x+0.5, y+0.5)."""
    y, x = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32) + 0.5,
        jnp.arange(w, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    return x, y


def block_fragcoord(bh: int, bw: int, y0, x0):
    """Fragcoords of a [bh, bw] block whose top-left pixel sits at
    (x0, y0) of the full target — the sharded post passes evaluate
    each device's block of the same full-resolution shader
    (`parallel.sharded.render_frame_sharded`)."""
    fx, fy = _fragcoord(bh, bw)
    return fx + jnp.asarray(x0, jnp.float32), fy + jnp.asarray(y0, jnp.float32)


def _reflect(incident, normal):
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N, batched over [..., 2]."""
    d = jnp.sum(incident * normal, axis=-1, keepdims=True)
    return incident - 2.0 * d * normal


def ssao_pass(
    position: Array,
    normal: Array,
    noise: Array,
    params: SSAOParams,
    sample_radius: Array,
    out_h: int,
    out_w: int,
    frag=None,
) -> Array:
    """`post_ssao.glsl` on the whole image -> AO [out_h, out_w].

    position/normal: [H, W, 3] G-buffer planes (full resolution; sampled
    NEAREST like the reference's G-buffer textures). The SSAO target may
    be smaller (downScale, `SSAO.cpp:58`).

    `frag` = (fx, fy) overrides the fragcoord grid to evaluate only a
    block of the (out_h, out_w) target (sharded post; see
    `block_fragcoord`). out_h/out_w keep their full-target meaning for
    the uv normalization either way.
    """
    fx, fy = frag if frag is not None else _fragcoord(out_h, out_w)
    fb = jnp.asarray([out_w, out_h], jnp.float32)
    uv_x, uv_y = fx / fb[0], fy / fb[1]

    pos = sample_nearest_clamp(position, uv_x, uv_y)  # [h, w, 3]
    nrm = sample_nearest_clamp(normal, uv_x, uv_y)
    sky = jnp.sum(pos * pos, axis=-1) == 0.0  # length(position)==0 (:33)

    # rad = SSAOSampleRadius / sqrt(|position.z|)  (:42)
    rad = sample_radius / jnp.sqrt(jnp.maximum(jnp.abs(pos[..., 2]), 1e-20))

    # random reflection vector from the LINEAR+REPEAT noise texture (:44)
    nz = sample_bilinear_repeat(noise, uv_x * 0.1, uv_y * 0.1)[..., :2]
    nz = nz * 2.0 - 1.0
    nz = nz / jnp.sqrt(jnp.maximum(jnp.sum(nz * nz, axis=-1, keepdims=True), 1e-20))

    def occlude(off_x, off_y):
        """`occlude()` (:19-25): offset in SSAO-target pixels."""
        su = (fx + off_x) / fb[0]
        sv = (fy + off_y) / fb[1]
        sample_pos = sample_nearest_clamp(position, su, sv)
        diff = sample_pos - pos
        dist2 = jnp.sum(diff * diff, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
        d = jnp.sum(nrm * diff, axis=-1) / dist
        occ = jnp.maximum(0.0, d - params.bias)
        occ = occ * (1.0 / (1.0 + dist2 * params.scale)) * params.intensity
        return jnp.where(dist2 > 0, occ, 0.0)

    ao = jnp.zeros_like(fx)
    for i in range(4):
        coord1 = _reflect(jnp.broadcast_to(_KERNEL[i], nz.shape), nz) * rad[..., None]
        c2x = coord1[..., 0] * 0.707 - coord1[..., 1] * 0.707
        c2y = coord1[..., 0] * 0.707 + coord1[..., 1] * 0.707
        ao = ao + occlude(coord1[..., 0] * 0.25, coord1[..., 1] * 0.25)
        ao = ao + occlude(coord1[..., 0] * 0.75, coord1[..., 1] * 0.75)
        ao = ao + occlude(c2x * 0.5, c2y * 0.5)
        ao = ao + occlude(c2x, c2y)

    ao = 1.0 - ao / 16.0  # (:58-59)
    return jnp.where(sky, 0.0, ao)  # sky writes black (:33-37)


def blur_pass(
    source: Array,
    position: Array,
    normal: Array,
    params: SSAOParams,
    direction: tuple[float, float],
    out_h: int,
    out_w: int,
    frag=None,
) -> Array:
    """`post_ssao_blur.glsl`: depth/normal-gated separable gaussian.

    source: [h, w] AO plane (LINEAR-filtered like the FBO texture it
    replaces); position/normal: full-res G-buffer (NEAREST).
    `frag` evaluates a block of the full target (see `ssao_pass`).
    """
    fx, fy = frag if frag is not None else _fragcoord(out_h, out_w)
    uv_x, uv_y = fx / out_w, fy / out_h

    pos = sample_nearest_clamp(position, uv_x, uv_y)
    nrm = sample_nearest_clamp(normal, uv_x, uv_y)

    dx, dy = direction
    color = jnp.zeros_like(fx)
    leftover = jnp.zeros_like(fx)

    for i in (1, 2):
        off = _BLUR_OFFSET[i - 1]
        wgt = _BLUR_WEIGHT[i]
        ox, oy = dx * off / out_w, dy * off / out_h  # normalized offsets
        for sign in (1.0, -1.0):
            s_pos = sample_nearest_clamp(position, uv_x + sign * ox, uv_y + sign * oy)
            s_nrm = sample_nearest_clamp(normal, uv_x + sign * ox, uv_y + sign * oy)
            gate = (jnp.sum(nrm * s_nrm, axis=-1) >= params.normal_threshold) & (
                jnp.abs(s_pos[..., 2] - pos[..., 2]) >= params.depth_threshold
            )
            tap = sample_bilinear_clamp(source, uv_x + sign * ox, uv_y + sign * oy)
            color = color + jnp.where(gate, tap * wgt, 0.0)
            leftover = leftover + jnp.where(gate, 0.0, wgt)

    center = sample_bilinear_clamp(source, uv_x, uv_y)
    return color + center * (_BLUR_WEIGHT[0] + leftover)


def composite_pass(
    position: Array,
    ssao: Array,
    camera_position: Array,
    out_h: int,
    out_w: int,
    frag=None,
) -> Array:
    """`post_final.glsl`: sky -> black; else
    (0.5 + 0.5*(position + cameraPosition)) * ssao.
    `frag` evaluates a block of the full target (see `ssao_pass`)."""
    fx, fy = frag if frag is not None else _fragcoord(out_h, out_w)
    uv_x, uv_y = fx / out_w, fy / out_h
    pos = sample_nearest_clamp(position, uv_x, uv_y)
    sky = jnp.sum(pos * pos, axis=-1) == 0.0
    ao = sample_nearest_clamp(ssao, uv_x, uv_y)
    color = (0.5 + 0.5 * (pos + camera_position)) * ao[..., None]
    return jnp.where(sky[..., None], 0.0, color)


@partial(jax.jit, static_argnames=("cfg",))
def postprocess(
    position: Array,
    normal: Array,
    closest_distance: Array,
    scene: SceneParams,
    cfg: RenderConfig,
    noise: Array,
) -> Array:
    """The full GPU stage of the reference (`SSAO::Render` + final pass):
    returns the final RGB image [H, W, 3]."""
    h, w = cfg.height, cfg.width
    sh, sw = h // cfg.ssao_downscale, w // cfg.ssao_downscale
    radius = scene.ssao.radius_multiplier * closest_distance  # SSAO.h:15-18
    ao = ssao_pass(position, normal, noise, scene.ssao, radius, sh, sw)
    ao = blur_pass(ao, position, normal, scene.ssao, (1.0, 0.0), h, w)
    ao = blur_pass(ao, position, normal, scene.ssao, (0.0, 1.0), h, w)
    return composite_pass(position, ao, scene.camera.position, h, w)
