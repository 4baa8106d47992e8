"""Camera model and per-pixel ray generation.

The reference has no explicit ray generator: it rasterizes a unit cube
(TestMain.cpp:94-114) through look_at/perspective matrices
(TestMain.cpp:222-228, shaders/vert.glsl:19-20) purely so the fragment
shader fires per covered pixel, then reconstructs the ray as
normalize(fragPos - cameraPos) in box-local space (shaders/frag.glsl:36-38).
A rasterizer needs proxy geometry to trigger fragments; a ray program does
not — we generate camera rays analytically per pixel, which covers exactly the
same rays (every cube-covering pixel's ray) plus the misses, which the AABB
test rejects.

Conventions match the reference: right-handed look-at (glm::lookAt,
TestMain.cpp:225: eye (3,3,3), center origin, up +Z), vertical-FOV pinhole
projection (glm::perspective 45deg, TestMain.cpp:226), image row 0 at the
top (Vulkan Y-flip, TestMain.cpp:228).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from ..config import CameraConfig


@dataclasses.dataclass(frozen=True)
class Camera:
    """Resolved camera: orthonormal basis + tangents, ready for ray gen.

    All fields are jnp arrays so a Camera can be built from traced values
    (animated camera paths, BASELINE config 4)."""

    eye: jnp.ndarray       # (3,)
    right: jnp.ndarray     # (3,) unit
    up: jnp.ndarray        # (3,) unit
    forward: jnp.ndarray   # (3,) unit, towards the scene
    tan_half_fov: jnp.ndarray  # scalar
    aspect: float
    width: int
    height: int


def make_camera(cfg: CameraConfig) -> Camera:
    return look_at_camera(
        jnp.asarray(cfg.eye, jnp.float32),
        jnp.asarray(cfg.center, jnp.float32),
        jnp.asarray(cfg.up, jnp.float32),
        cfg.fov_y_degrees,
        cfg.width,
        cfg.height,
    )


def look_at_camera(eye, center, up, fov_y_degrees, width, height) -> Camera:
    """Build a Camera from look-at parameters (glm::lookAt semantics)."""
    eye = jnp.asarray(eye, jnp.float32)
    forward = center - eye
    forward = forward / jnp.linalg.norm(forward)
    right = jnp.cross(forward, jnp.asarray(up, jnp.float32))
    right = right / jnp.linalg.norm(right)
    true_up = jnp.cross(right, forward)
    tan_half = jnp.tan(jnp.deg2rad(jnp.asarray(fov_y_degrees, jnp.float32)) / 2.0)
    return Camera(
        eye=eye,
        right=right,
        up=true_up,
        forward=forward,
        tan_half_fov=tan_half,
        aspect=width / height,
        width=width,
        height=height,
    )


def camera_rays(cam: Camera) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel ray origins and unit directions.

    Returns (origins (H, W, 3), directions (H, W, 3)). Pixel centers are
    sampled ((i+0.5)/W), row 0 is the top of the image (Vulkan convention,
    TestMain.cpp:228's Y-flip)."""
    w, h = cam.width, cam.height
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * 2.0
    px, py = jnp.meshgrid(xs, ys, indexing="xy")  # (H, W)

    dirs = (
        px[..., None] * (cam.right * cam.tan_half_fov * cam.aspect)
        + py[..., None] * (cam.up * cam.tan_half_fov)
        + cam.forward
    )
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(cam.eye, dirs.shape)
    return origins, dirs


def orbit_camera(t, radius=27.0 ** 0.5, height_z=3.0, fov_y_degrees=45.0,
                 width=1920, height=1080) -> Camera:
    """Animated orbit camera path (BASELINE config 4): angle t in radians
    around the Z axis at fixed elevation, always looking at the origin.

    Default radius/height place t=pi/4 at the reference's fixed eye
    (3,3,3) (TestMain.cpp:225,242)."""
    t = jnp.asarray(t, jnp.float32)
    r_xy = jnp.sqrt(jnp.maximum(radius * radius - height_z * height_z, 1e-6))
    eye = jnp.stack([r_xy * jnp.cos(t), r_xy * jnp.sin(t),
                     jnp.asarray(height_z, jnp.float32)])
    return look_at_camera(
        eye,
        jnp.zeros(3, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
        fov_y_degrees,
        width,
        height,
    )
