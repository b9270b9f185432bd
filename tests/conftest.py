"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(the 512-device override is exclusively for launch/dryrun.py, which sets it
before importing jax). Distribution tests spawn subprocesses instead."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def tiny_cfg():
    from repro.configs import get_config
    return get_config("tiny")


@pytest.fixture(scope="session")
def tiny_params(tiny_cfg):
    import jax
    from repro.models import model as M
    return M.init_params(tiny_cfg, jax.random.PRNGKey(0))
