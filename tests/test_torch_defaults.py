"""The port's entry points run on the card unless the caller asks for the
CPU: every constructor of device state defaults to CUDA (read from the
signatures, allocating nothing), a SlamSystem built with no device
argument lies on CUDA, or raises where there is no card, and so does the
facade with asynchronous mapping; ``load_atlas`` restores onto the
system's device."""

import inspect
import types

import pytest
import torch

from mam3slam_tpu_torch import api, convert
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.io import render, settings
from mam3slam_tpu_torch.mapstate import checkpoint
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.slam import system

ENTRY_POINTS = {
    "make_pinhole": cameras.make_pinhole,
    "make_kb8": cameras.make_kb8,
    "init_map_state": S.init_map_state,
    "RoomScene": render.RoomScene,
    "convert.tensor": convert.tensor,
    "convert.camera_from_numpy": convert.camera_from_numpy,
    "convert.from_numpy": convert.from_numpy,
    "convert.frame_from_numpy": convert.frame_from_numpy,
    "convert.map_state_from_numpy": convert.map_state_from_numpy,
    "convert.vocabulary_from_numpy": convert.vocabulary_from_numpy,
    "MultiAgentSystem": api.MultiAgentSystem,
    "Settings.camera": settings.Settings.camera,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert torch.device(default.default) == torch.device("cuda")


def test_slam_system_without_device_lies_on_cuda_or_raises():
    cfg = system.SlamConfig(width=64, height=48, n_feat=32, max_kf=4,
                            max_mp=64)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            system.SlamSystem(cfg, cameras.make_pinhole(40.0, 40.0, 32.0,
                                                        24.0))
        return
    sys_ = system.SlamSystem(cfg, cameras.make_pinhole(40.0, 40.0, 32.0,
                                                       24.0))
    assert sys_.device.type == "cuda" and sys_.ms.kf_q.is_cuda


def test_cpu_on_request():
    cfg = system.SlamConfig(width=64, height=48, n_feat=32, max_kf=4,
                            max_mp=64)
    sys_ = system.SlamSystem(cfg, cameras.make_pinhole(
        40.0, 40.0, 32.0, 24.0, device="cpu"))
    assert sys_.device.type == "cpu" and sys_.ms.kf_q.device.type == "cpu"


def test_async_facade_without_device_lies_on_cuda_or_raises():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            api.MultiAgentSystem(async_mapping=True, pipeline=True)
        return
    mas = api.MultiAgentSystem(async_mapping=True, pipeline=True)
    assert mas.device.type == "cuda"


def test_load_atlas_follows_the_system_device(tmp_path):
    """The restored state lands on ``system.device`` (the card unless the
    system was built elsewhere), not where the file was written."""
    cfg = system.SlamConfig(width=64, height=48, n_feat=32, max_kf=4,
                            max_mp=64)
    src = system.SlamSystem(cfg, cameras.make_pinhole(
        40.0, 40.0, 32.0, 24.0, device="cpu"))
    src.add_agent()
    path = str(tmp_path / "atlas.npz")
    checkpoint.save_atlas(src, path)
    for dev in ("meta", "cuda"):
        if dev == "cuda" and not torch.cuda.is_available():
            continue
        dst = types.SimpleNamespace(device=torch.device(dev),
                                    agents=src.agents,
                                    add_agent=src.add_agent)
        checkpoint.load_atlas(dst, path)
        assert all(t.device.type == dev for t in dst.ms)
