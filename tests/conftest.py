import os

# Smoke tests and benches must see the single real CPU device — the 512-way
# override belongs ONLY to launch/dryrun.py (see system DESIGN.md).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def np_rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit (skips elsewhere)")
