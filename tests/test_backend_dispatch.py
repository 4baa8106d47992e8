"""The backend argument must never SILENTLY select the per-ray oracle
(the slow path render.py guards loudly): unknown values raise, including
"pallas", which named a kernel that no longer exists."""
import pytest

from volumetricrenderer_tpu.config import get_preset
from volumetricrenderer_tpu.models.scene import build_volume
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.render import render_image


def _setup():
    import dataclasses
    p = get_preset("config1")
    p = dataclasses.replace(
        p, volume=dataclasses.replace(p.volume, size=8),
        camera=dataclasses.replace(p.camera, width=32, height=24))
    grid = build_volume(p.volume)
    cam = make_camera(p.camera)
    return p, grid, cam


def test_pallas_backend_raises():
    p, grid, cam = _setup()
    with pytest.raises(ValueError, match="unknown backend"):
        render_image(grid, cam, p.render, p.medium, p.light,
                     backend="pallas")


def test_unknown_backend_raises():
    p, grid, cam = _setup()
    with pytest.raises(ValueError, match="unknown backend"):
        render_image(grid, cam, p.render, p.medium, p.light,
                     backend="palas")  # typo must not mean 'oracle'


def test_cli_rejects_pallas_choice(capsys):
    from volumetricrenderer_tpu.cli import main

    with pytest.raises(SystemExit) as e:
        main(["render", "--backend", "pallas"])
    assert e.value.code == 2  # argparse: invalid choice
    assert "invalid choice" in capsys.readouterr().err
