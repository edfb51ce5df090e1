"""Test configuration: an 8-device virtual CPU mesh by default, the GPU on
request.

Default: all tests run on CPU (fast, deterministic, no accelerator
needed); the sharding tests get 8 virtual devices via XLA_FLAGS, the
strategy described in SURVEY.md §4.5.  Must run before jax initializes its
backends.

Hardware tier: `CAITLYN_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu`
leaves the backend alone and runs the `gpu`-marked tests (the compiled
CUDA traversal against the XLA references) on the card.  Whether a card is
present is decided per test in the `_hardware_tier` fixture, never at
import, so every xdist worker collects the same tests.
"""

import os

_PLATFORM = os.environ.get("CAITLYN_TEST_PLATFORM", "cpu")

if _PLATFORM != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

# jax may already be imported by a plugin, in which case the env var alone
# is ignored — force the platform through the config API as well.
import jax

if _PLATFORM != "gpu":
    jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

from caitlyn.io.builtin_scenes import builtin_camera
from caitlyn.io.obj import load_obj

REFERENCE_OBJ = "/root/reference/Models/cornell-box.obj"


@pytest.fixture(autouse=True)
def _hardware_tier(request):
    """Skip `gpu`-marked tests unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (CAITLYN_TEST_PLATFORM=gpu)")


@pytest.fixture
def eight_devices():
    """The 8 virtual CPU devices of the sharding tests."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax.devices()[:8]


@pytest.fixture(scope="session")
def cornell():
    """The cornell-box scene + its camera.

    Uses the reference's asset when mounted, else the procedural twin; both
    live in the same origin frame (load_obj translates the asset the way
    `Scene.h:922-925` does), so the scene's one camera
    (io/builtin_scenes.CAMERAS) frames either.
    """
    if os.path.exists(REFERENCE_OBJ):
        scene, _ = load_obj(REFERENCE_OBJ)
    else:
        from caitlyn.io.builtin_scenes import cornell_box

        scene, _ = cornell_box()
    return scene, builtin_camera("cornell")
