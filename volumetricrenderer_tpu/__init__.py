"""volumetricrenderer_tpu — a differentiable volumetric renderer.

A from-scratch JAX framework with the capabilities of the reference
Vulkan renderer (Raspy-Py/VolumetricRenderer): procedural-noise density
volumes, camera ray generation, fixed-step emission-absorption ray marching
with trilinear 3D sampling, Beer-Lambert compositing — plus, beyond the
reference: full differentiability (voxel gradients), directional lighting
with shadow marches, transmittance early exit, multi-device sharding over
device meshes, checkpointing, and a batch/animation CLI in place of the
interactive window.
"""

from .config import (  # noqa: F401
    CameraConfig,
    LightConfig,
    MediumConfig,
    NoiseChannelConfig,
    Preset,
    PRESETS,
    RenderConfig,
    VolumeConfig,
    get_preset,
)
from .models.scene import (  # noqa: F401
    Volume,
    build_volume,
    cloud_volume,
    smoke_volume,
    two_volume_grid,
)
from .ops.camera import (  # noqa: F401
    Camera,
    camera_rays,
    look_at_camera,
    make_camera,
    orbit_camera,
)
from .ops.integrate import (  # noqa: F401
    reference_media_scroll,
    render_rays,
    transform_rays,
)
from .render import render, render_image, render_preset  # noqa: F401

__version__ = "0.1.0"
