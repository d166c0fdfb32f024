import os
import sys

import pytest

# Tests run on the CPU with 8 virtual devices, so the mesh and sharding
# logic runs without a card.  The card-only tests carry the `gpu` marker
# and run on an NVIDIA GPU with
#     JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is an NVIDIA GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
