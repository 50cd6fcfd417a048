"""Configuration and parameter pytrees.

The reference splits state between hardcoded constants (camera start pose
`main.cpp:93-96`, SSAO tuning `SSAO.cpp:49-55`, LOD thresholds
`SIMD_AVX.h:25` / `SIMD_SSE.h:21`) and a `--key=value` CLI singleton
(`CommandLine.h:14-74`) that only reads width/height/fullscreen
(`main.cpp:370-380`).

Here the split follows JAX's compile model instead:

- ``RenderConfig`` — *static* compile-time configuration (shapes, tile
  sizes, depth bounds). Changing it triggers re-jit.
- ``CameraParams`` / ``FractalParams`` / ``SSAOParams`` — *traced*
  parameter pytrees. Every leaf is differentiable; `jax.grad` flows
  through camera pose, fractal geometry and SSAO constants.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


def _f32(x) -> jax.Array:
    return jnp.asarray(x, dtype=jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CameraParams:
    """Differentiable pinhole camera, parameterized exactly like the
    reference (`camera.h:7-123`): position + Euler angles + fov.

    Naming quirk preserved from the reference: ``yaw`` rotates about the
    *x* axis and ``pitch`` about *y*, because `camera.h:65-68` builds
    `quat(vec3(m_Yaw, m_Pitch, m_Roll))` and GLM's Euler constructor
    treats the vector as (x, y, z) angles.
    """

    position: Array  # [3] world position
    yaw: Array  # rotation about x (radians)
    pitch: Array  # rotation about y (radians)
    roll: Array  # rotation about z (radians)
    fov: Array  # vertical-ish field of view in DEGREES (reference: 60)

    @staticmethod
    def reference_default() -> "CameraParams":
        """The hardcoded startup pose of the reference app (`main.cpp:93-96`)."""
        return CameraParams(
            position=_f32([-5.4098, -7.2139, 1.19006]),
            yaw=_f32(0.921999),
            pitch=_f32(-1.371),
            roll=_f32(0.0),
            fov=_f32(60.0),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FractalParams:
    """Differentiable sphereflake geometry.

    The reference hardcodes the 9-ary child layout
    (`Sphereflake.cpp:216-249`): 6 equatorial children at longitude 90°,
    latitude 60°·i with orientation (90, 90+60·i, 0), and 3 polar children
    at longitude 30°, latitude 30°+120°·i with fixed rotations
    {(325,45,15), (145,230,165), (60,0,0)}; child radius = parent/3
    (`Sphereflake.h:97`); displacement = (4/3)·r = (1+ratio)·r tangent
    distance (`Sphereflake.h:162-168`).

    Here all of that is a parameter pytree so gradients can fit it.
    """

    radius_ratio: Array  # child_radius / parent_radius (reference: 1/3)
    root_radius: Array  # radius of the top sphere (reference: 1 = 3.0/3)
    child_rotations_deg: Array  # [9, 3] XYZ Euler angles in degrees
    child_longlat_deg: Array  # [9, 2] (longitude, latitude) of displacement dir

    @staticmethod
    def reference_default() -> "FractalParams":
        rotations = np.zeros((9, 3), dtype=np.float32)
        longlat = np.zeros((9, 2), dtype=np.float32)
        for i in range(6):  # equatorial ring (Sphereflake.cpp:218-231)
            rotations[i] = (90.0, 90.0 + 60.0 * i, 0.0)
            longlat[i] = (90.0, 60.0 * i)
        polar_rotations = [(325.0, 45.0, 15.0), (145.0, 230.0, 165.0), (60.0, 0.0, 0.0)]
        for i in range(3):  # polar cap (Sphereflake.cpp:233-248)
            rotations[6 + i] = polar_rotations[i]
            longlat[6 + i] = (30.0, 30.0 + 120.0 * i)
        return FractalParams(
            radius_ratio=_f32(1.0 / 3.0),
            root_radius=_f32(1.0),
            child_rotations_deg=_f32(rotations),
            child_longlat_deg=_f32(longlat),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SSAOParams:
    """SSAO/blur/composite tuning, matching `SSAO.cpp:49-55` and the
    radius law `SSAOSampleRadius = 8 * closestSphereDistance`
    (`SSAO.h:15-18`, fed at `main.cpp:316`)."""

    intensity: Array  # 0.51
    scale: Array  # 3.28
    bias: Array  # 0.23
    normal_threshold: Array  # 2.47 (blur edge gate; see post_ssao_blur.glsl:46)
    depth_threshold: Array  # 0.01
    radius_multiplier: Array  # 8.0 (SSAO.h:17)

    @staticmethod
    def reference_default() -> "SSAOParams":
        return SSAOParams(
            intensity=_f32(0.51),
            scale=_f32(3.28),
            bias=_f32(0.23),
            normal_threshold=_f32(2.47),
            depth_threshold=_f32(0.01),
            radius_multiplier=_f32(8.0),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneParams:
    """The full differentiable parameter pytree: `params -> image`."""

    camera: CameraParams
    fractal: FractalParams
    ssao: SSAOParams


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) render configuration.

    Mirrors the reference's CLI surface (`--width/--height`,
    `main.cpp:370-380`, defaults 1280x720 `main.cpp:49-50`) and its
    compile-time knobs (AVX vs SSE packet width -> tile shape; LOD
    constant 70/60 -> ``lod_factor``), plus the depth bound that the
    reference leaves implicit (unbounded, LOD-terminated,
    `Sphereflake.h:146-153`).
    """

    width: int = 1280
    height: int = 720
    max_depth: int = 4  # deepest fractal level rendered (level 0 = root sphere)
    lod_factor: float = 70.0  # recurse while sqrt(t/r) < lod_factor (AVX value)
    tile_h: int = 64  # screen-tile height (the "packet" of this build)
    tile_w: int = 128  # screen-tile width; lanes dimension, keep multiple of 128
    max_frontier: int = 1024  # per-tile cap on live spheres per level
    tile_batch: int = 16  # tiles traced concurrently (memory/parallelism knob)
    # "binned": frame-global expansion + screen binning + one trace
    #           kernel (production path; interpreted on CPU).
    # "fast": cone-culled expansion, node-local per-ray gating (XLA).
    # "strict": exact per-ray ancestor-chain gating (golden parity).
    # "loose": any-ray expansion without cone culling (diagnostics).
    algorithm: str = "fast"
    strict_lod: bool = True  # per-ray gating inside the non-fast paths
    # Binned path: render the frame in horizontal bands of this many
    # tile rows, each binned separately (bounds the pair table and the
    # live working set — required for 16384^2 frames, `README.md:51`).
    # None = auto: whole frame when it fits PAIR_CAP comfortably, else
    # ~2048-tile bands.
    band_tile_rows: int | None = None
    # Binned path: live-node capacity per fractal level once the dense
    # level width would exceed it (level >= 5 at the default). The LOD
    # cut keeps live counts far below the dense width (the reference's
    # recursion is unbounded for the same reason,
    # `Sphereflake.h:146-153`); overflow is counted, never silent, and
    # the compaction drops farthest-first. The default is 9x the
    # pre-expansion cap (global_cap // 9), so a compacted level's
    # children exactly fill the next level with no second sort.
    global_cap: int = 9 << 13
    ssao_downscale: int = 1  # SSAO target downscale (main.cpp:118 uses 1)
    noise_size: int = 64  # SSAO noise texture size (SSAO.h:4)
    background: float = 0.0  # sky writes zeros (post_final.glsl:20-24)

    def __post_init__(self):
        if self.algorithm == "binned":
            # One trace-kernel program traces one 1024-ray tile; the
            # image is padded to a tile multiple and cropped after.
            if self.tile_h * self.tile_w != 1024:
                raise ValueError(
                    "algorithm='binned' requires tile_h * tile_w == 1024 "
                    "(one kernel program's rays), got "
                    f"{self.tile_h}x{self.tile_w}"
                )
        elif self.width % self.tile_w or self.height % self.tile_h:
            raise ValueError(
                f"image {self.width}x{self.height} must be divisible by "
                f"tile {self.tile_w}x{self.tile_h}"
            )
        if self.algorithm == "binned" and self.max_depth > 13:
            raise ValueError(
                f"max_depth {self.max_depth} > 13 is not renderable in "
                "f32: the two-lane path code is exact only through "
                "level 13 (hi < 9^7 < 2^24), and level-13 spheres "
                "(radius 3^-13 ~ 6.3e-7) already sit near the f32 "
                "relative-precision floor of the center coordinates "
                "(eps ~ 1.2e-7) — deeper levels would render garbage, "
                "not geometry (see ops/binned.py DEEP_MAX_DEPTH)"
            )
        if self.max_depth < 0:
            raise ValueError("max_depth must be >= 0")
        if self.band_tile_rows is not None:
            if self.algorithm != "binned":
                raise ValueError("band_tile_rows requires algorithm='binned'")
            if self.tiles_y % self.band_tile_rows:
                raise ValueError(
                    f"tiles_y {self.tiles_y} not divisible by "
                    f"band_tile_rows {self.band_tile_rows}"
                )

    @property
    def pair_cap(self) -> int:
        """Static (node, tile) pair-table capacity for the binned path.

        Pairs scale with tiles (~80 per tile at the reference pose,
        which needs ~59), with live nodes (a small frame still pairs
        every live node with at least one tile), and — on deep-dive
        configs — with DEPTH: past level 7 the live set spans many
        capped levels (up to ~global_cap each; an interior dive pose
        really does carry 5+ near-cap levels at once), so the node
        term grows by max_depth - 6. The budget is the max of all
        terms, capped at 2^20 (the fill packing's `first` bit budget).
        Overflow is counted and fails the bench rather than dropping
        silently; the capacity ladder doubles global_cap (and with it
        this cap) on retry."""
        tiles = self.tiles_x * self.tiles_y
        depth_levels = max(1, self.max_depth - 6)
        return min(
            1 << 20,
            max(2 * self.global_cap * depth_levels,
                -(-tiles * 64 // 2048) * 2048),
        )

    @property
    def effective_band_rows(self) -> int | None:
        """Band height in tile rows for the binned path, or None for a
        whole-frame bin. Auto-bands frames whose tile count would
        overflow the pair table (~2048 tiles per band)."""
        if self.band_tile_rows is not None:
            return self.band_tile_rows
        if self.algorithm != "binned" or self.tiles_x * self.tiles_y <= 4096:
            return None
        rows = max(1, 2048 // self.tiles_x)
        while rows > 1 and self.tiles_y % rows:
            rows -= 1
        return rows

    @property
    def padded_width(self) -> int:
        """Width rounded up to a tile multiple (binned pads + crops)."""
        return -(-self.width // self.tile_w) * self.tile_w

    @property
    def padded_height(self) -> int:
        return -(-self.height // self.tile_h) * self.tile_h

    @property
    def tiles_x(self) -> int:
        return self.padded_width // self.tile_w

    @property
    def tiles_y(self) -> int:
        return self.padded_height // self.tile_h

    @property
    def aspect(self) -> float:
        return self.width / self.height


def default_scene() -> SceneParams:
    """Scene parameters matching the reference app's startup state."""
    return SceneParams(
        camera=CameraParams.reference_default(),
        fractal=FractalParams.reference_default(),
        ssao=SSAOParams.reference_default(),
    )
