"""Test config: an 8-device virtual CPU mesh, set before any backend
initializes, so the sharded paths run on any machine.

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them unless JAX can open a GPU.  On
a machine with one, ``MONICA_GPU_TESTS=1`` adds the CUDA backend beside
the CPU mesh (the CPU stays the default device) so those tests run:

    MONICA_GPU_TESTS=1 python -m pytest tests -m gpu
"""

import os
import sys

import jax  # noqa: E402
import pytest

jax.config.update(
    "jax_platforms", "cpu,cuda" if os.environ.get("MONICA_GPU_TESTS") == "1" else "cpu"
)
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when a test runs, never at import."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with MONICA_GPU_TESTS=1 on the card)")
