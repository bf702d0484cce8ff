import os

# Keep the smoke/bench environment at 1 device; ONLY launch/dryrun.py sets
# the 512-device host-platform flag (and does so before importing jax).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skips without one")
