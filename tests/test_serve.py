"""Live interactive loop (serve.py): key events mutate the orbit camera
and media clock server-side; frames stream through the real HTTP stack
and re-render through cached executables. CPU-sized scene.
"""
import dataclasses
import json
import socket
import urllib.request

import numpy as np
import pytest

from volumetricrenderer_tpu.config import PRESETS, CameraConfig, VolumeConfig
from volumetricrenderer_tpu.serve import InteractiveRenderer, serve


def _small_preset():
    p = PRESETS["config2"]
    return dataclasses.replace(
        p,
        volume=dataclasses.replace(p.volume, size=16),
        camera=dataclasses.replace(p.camera, width=64, height=48),
    )


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_interactive_renderer_state_and_frames():
    r = InteractiveRenderer(_small_preset(), probe=4)
    # uint8 RGB composited over the page background on device (present
    # format; alpha is baked in to cut download bytes)
    f0 = r.render_frame().astype(np.int32)
    assert f0.shape == (48, 64, 3)
    st0 = dict(r.state())
    r.key("a")
    r.key("w")
    r.key("r")
    st1 = r.state()
    assert st1["azim"] != st0["azim"]
    assert st1["dist"] < st0["dist"]
    assert st1["t"] > st0["t"]
    f1 = r.render_frame().astype(np.int32)
    # the camera moved: the image must actually change
    assert np.abs(f1 - f0).max() > 0
    # executables are shared across interactions (compile-stable plans):
    # one per (axis, sign) family the path crosses, not one per frame
    for k in "adqeadqe":
        r.key(k)
        r.render_frame()
    n_frames = r.frames_rendered
    assert len(r._signatures) <= 3, r._signatures
    assert n_frames > 2 * len(r._signatures)


def test_serve_selftest_http_roundtrip():
    res = serve(_small_preset(), port=_free_port(), frames=4)
    assert res["frames"] == 4
    assert res["fps"] > 0
    assert res["png_bytes_mean"] > 100
    assert res["final_state"]["frames"] >= 5  # warmup + 4


def test_serve_state_endpoint_is_json():
    port = _free_port()
    res = serve(_small_preset(), port=port, frames=1)
    assert set(res["final_state"]) >= {"azim", "elev", "dist", "t",
                                       "playing"}
    json.dumps(res)  # artifact-serializable


def test_azimuth_lattice_wraps_exactly():
    # ADVICE r4: azim must live on an exact periodic lattice so a full
    # orbit revisits cached plans instead of minting new cache keys.
    from volumetricrenderer_tpu.serve import N_AZ
    r = InteractiveRenderer(_small_preset(), probe=4)
    az0 = r.azim
    seen = set()
    for _ in range(N_AZ):
        seen.add(round(r.azim, 9))
        r.key("d")
    assert r.azim == pytest.approx(az0, abs=1e-12)  # exact wrap
    assert len(seen) == N_AZ
    # going backwards hits the same lattice points
    for _ in range(3):
        r.key("a")
    assert round(r.azim, 9) in seen


def test_frameloop_error_is_sticky_until_next_frame():
    # ADVICE r4: a render error must fail EVERY concurrent waiter fast,
    # not just the first one.
    from volumetricrenderer_tpu.serve import FrameLoop

    class Boom:
        frames_rendered = 0

        def dispatch_frame(self):
            raise RuntimeError("render broke")

    loop = FrameLoop(Boom())
    try:
        for _ in range(2):  # every waiter sees the sticky error
            with pytest.raises(RuntimeError, match="render broke"):
                loop.next_frame(0, timeout=10)
    finally:
        loop.stop()


def test_mouse_drag_and_wheel_drive_the_lattice():
    """Pointer drag orbits and wheel dollies (Mouse.h:5-44 parity),
    quantized onto the SAME key lattice so plans/executables cache."""
    r = InteractiveRenderer(_small_preset(), probe=4)
    st0 = dict(r.state())
    # sub-step drags accumulate server-side (no state change yet)
    st = r.drag(10, 0)
    assert st["azim"] == st0["azim"]
    st = r.drag(38, -50)  # 48px right = 2 az steps; 50px up = 2 el steps
    assert st["azim"] != st0["azim"]
    assert st["elev"] > st0["elev"]
    # the reached azimuth is ON the key lattice (a 'd' then 'a' returns)
    az = r.azim
    r.key("d"); r.key("a")
    assert r.azim == pytest.approx(az, abs=1e-12)
    st1 = r.wheel(1)
    assert st1["dist"] > st["dist"]
    st2 = r.wheel(-1)
    assert st2["dist"] == pytest.approx(st["dist"], abs=1e-9)


def test_serve_selftest_reports_mouse_ok():
    res = serve(_small_preset(), port=_free_port(), frames=2)
    assert res["mouse_drag_wheel_ok"] is True
