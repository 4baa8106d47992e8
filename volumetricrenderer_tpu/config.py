"""Configuration system for the volumetric renderer.

The reference has no runtime config at all — every knob is a hard-coded
constant (window 1280x720 at VulkanContext.cpp:24, MAX_FRAMES_IN_FLIGHT=2 at
VulkanRenderer.cpp:13, volume size 128 at TestMain.cpp:51, maxSteps=128 /
density=1 / box bounds at shaders/frag.glsl:29-32, camera at
TestMain.cpp:225-226,242, noise frequencies/seeds at TestMain.cpp:59-62).

Here those constants become fields of frozen dataclasses (registered as JAX
pytrees where they carry traced data) with the reference values as defaults,
plus named presets for each BASELINE.json staged config.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

# Address modes for grid sampling — mirrors the reference sampler config
# (VK_SAMPLER_ADDRESS_MODE_MIRRORED_REPEAT at VulkanCore.cpp:683-685).
ADDRESS_MIRROR = "mirror"
ADDRESS_CLAMP = "clamp"
ADDRESS_WRAP = "wrap"


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera. Defaults mirror TestMain.cpp:225-226,242:
    eye (3,3,3) looking at origin, up +Z, 45 deg vertical fov, 1280x720."""

    eye: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    fov_y_degrees: float = 45.0
    width: int = 1280
    height: int = 720

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclasses.dataclass(frozen=True)
class LightConfig:
    """Single directional light (capability extension over the reference,
    which has no lighting — frag.glsl is absorption-only)."""

    direction: Tuple[float, float, float] = (0.5, 0.5, 1.0)  # towards light
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient: float = 0.1
    # Secondary light-march (shadow) parameters — BASELINE config 4.
    shadow_steps: int = 0  # 0 = no shadow march
    shadow_step_size: float = 0.0625


@dataclasses.dataclass(frozen=True)
class MediumConfig:
    """How the 4-channel grid is combined into extinction, replicating
    frag.glsl:63-71: per-channel coordinate scale + scroll offset, then
    sigma = (s1*s2)*(s3+s4)*scale.

    channel_coord_scale[i] scales the sample position for channel i
    (frag.glsl:66-69 uses 1.0, 0.8, 0.75, 0.7); channel_scroll_weight[i]
    weights the time-scroll offset (0.0, 0.2, 0.25, 0.3)."""

    channel_coord_scale: Tuple[float, float, float, float] = (1.0, 0.8, 0.75, 0.7)
    channel_scroll_weight: Tuple[float, float, float, float] = (0.0, 0.2, 0.25, 0.3)
    sample_scale: float = 0.2  # `scale` at frag.glsl:63
    density: float = 1.0  # `density` at frag.glsl:29
    # "reference" = (s1*s2)*(s3+s4)*scale (frag.glsl:71);
    # "single" = channel 0 directly (cloud/smoke configs).
    combine: str = "reference"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render configuration.

    March parameters mirror frag.glsl:29-32,42: box [-1,1]^3, 128 max steps,
    step size 4/128 in box-local units."""

    max_steps: int = 128
    step_size: float = 4.0 / 128.0
    box_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    box_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    address_mode: str = ADDRESS_MIRROR
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Emission-absorption mode (extension; reference is absorption-only).
    emission: bool = False
    # Transmittance early-exit threshold (reference has none: frag.glsl:57-75).
    early_stop_transmittance: float = 1e-3
    dtype: str = "float32"  # compute dtype; grids may be bf16
    # Integration quadrature:
    #   "fixed":  per-ray fixed steps (frag.glsl:42-46 parity; gather-bound,
    #             served by ops/integrate.render_rays).
    #   "sliced": slice-plane crossings with per-ray segment lengths (the
    #             slice-sweep, ops/sweep.py; oracle
    #             ops/integrate.render_rays_sliced). Same integral,
    #             different discretization.
    quadrature: str = "fixed"
    # Base-grid oversampling for the sweep's intermediate image.
    sweep_supersample: float = 1.5

    @property
    def jnp_dtype(self):
        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[self.dtype]


@dataclasses.dataclass(frozen=True)
class NoiseChannelConfig:
    """One procedural-noise channel — mirrors TestMain.cpp:59-62."""

    kind: str  # "cellular" | "perlin" | "simplex" | "fbm"
    frequency: float
    seed: int
    octaves: int = 1  # >1 only for fbm
    sharpen_power: int = 1  # TestMain.cpp:80 raises ch0 to the 4th power


@dataclasses.dataclass(frozen=True)
class VolumeConfig:
    """Procedural volume build recipe, mirroring TestMain.cpp:43-92:
    size 128, 4 channels [cellular f=0.01 s=1, cellular f=0.03 s=2,
    perlin f=0.19 s=3, simplex f=0.15 s=4], each min-max normalized and
    inverted, channel 0 sharpened by pow4.

    Note: the reference has a buffer-aliasing bug (TestMain.cpp:60 writes
    the second cellular pass into noiseOutput1, clobbering the first); we
    implement the evident intent (independent channels) and document the
    deviation."""

    size: int = 128
    channels: Tuple[NoiseChannelConfig, ...] = (
        NoiseChannelConfig("cellular", 0.01, 1, sharpen_power=4),
        NoiseChannelConfig("cellular", 0.03, 2),
        NoiseChannelConfig("perlin", 0.19, 3),
        NoiseChannelConfig("simplex", 0.15, 4),
    )
    quantize_uint8: bool = False  # reference stores RGBA8 (TestMain.cpp:84-87)


# ---------------------------------------------------------------------------
# Named presets — the five BASELINE.json staged configs.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    volume: VolumeConfig
    camera: CameraConfig
    render: RenderConfig
    medium: MediumConfig
    light: LightConfig
    # Multi-volume scene builder name in models.scene (e.g. "config3_scene");
    # None = single build_volume(volume) grid. When set, render_preset
    # routes through render_scene (per-volume world transforms).
    scene: str = ""


def _perlin_volume(size: int, seed: int = 3) -> VolumeConfig:
    return VolumeConfig(
        size=size,
        channels=(NoiseChannelConfig("perlin", 0.08, seed),),
    )


def _fbm_cloud(size: int, seed: int = 7) -> VolumeConfig:
    return VolumeConfig(
        size=size,
        channels=(NoiseChannelConfig("fbm", 4.0 / size, seed, octaves=5),),
    )


PRESETS = {
    # Config 1: 64^3 Perlin grid, 256x256, fixed camera, absorption only.
    "config1": Preset(
        name="config1",
        volume=_perlin_volume(64),
        camera=CameraConfig(width=256, height=256),
        render=RenderConfig(quadrature="sliced"),
        medium=MediumConfig(combine="single"),
        light=LightConfig(),
    ),
    # Config 2: 128^3 FBM cloud, 512x512, emission-absorption + 1 light.
    "config2": Preset(
        name="config2",
        volume=_fbm_cloud(128),
        camera=CameraConfig(width=512, height=512),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(),
    ),
    # Config 3: 256^3 cloud + smoke TWO-VOLUME scene, 1024x1024, full
    # backward. Built by models.scene.config3_scene (per-volume world
    # transforms); `volume` keeps the size/recipe for tooling.
    "config3": Preset(
        name="config3",
        volume=_fbm_cloud(256),
        camera=CameraConfig(width=1024, height=1024),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(),
        scene="config3_scene",
    ),
    # Config 4: 256^3 + shadow light-march, 1080p, animated camera.
    "config4": Preset(
        name="config4",
        volume=_fbm_cloud(256),
        camera=CameraConfig(width=1920, height=1080),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(shadow_steps=32),
    ),
    # Config 5: 512^3 spatially sharded, 1080p, multi-host.
    "config5": Preset(
        name="config5",
        volume=_fbm_cloud(512),
        camera=CameraConfig(width=1920, height=1080),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(),
    ),
    # Reference parity: 128^3 4-channel, 1280x720, reference combine.
    "reference": Preset(
        name="reference",
        volume=VolumeConfig(),
        camera=CameraConfig(),
        render=RenderConfig(),
        medium=MediumConfig(),
        light=LightConfig(),
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
