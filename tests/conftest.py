import os
import sys

# Tests run on a virtual 8-device CPU mesh; set before any jax import.
# MULTIZ_TEST_DEVICE=gpu keeps the card for the `gpu`-marked tests
# (README, "Running").
if os.environ.get("MULTIZ_TEST_DEVICE") != "gpu":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
