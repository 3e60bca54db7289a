"""Test configuration: run everything on a virtual 8-device CPU mesh so
sharding logic is exercised without accelerators (SURVEY.md §4).

Tests marked `gpu` need an NVIDIA GPU (kernels compiled for the card, no
interpreter); they take the `gpu_device` fixture, which skips them on the
CPU.  On a GPU host, `GPUSPECTRAL_TEST_GPU=1 python -m pytest tests/ -m gpu
-p no:xdist` lifts the CPU pin below and runs them in one process."""

import os

_ON_GPU = os.environ.get("GPUSPECTRAL_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pytest


REPO = pathlib.Path(__file__).resolve().parents[1]
CORNELL_XML = REPO / "scenes" / "cornell" / "scene.xml"


@pytest.fixture(scope="session")
def cornell_scene():
    from gpuspectral_tpu.scene import load_mitsuba_scene

    scene, builder = load_mitsuba_scene(str(CORNELL_XML))
    return scene


@pytest.fixture
def gpu_device():
    """The first JAX device, when it is an NVIDIA GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled kernels have no CPU path)")
    return dev
