"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set flags before the first ``import jax`` anywhere in the test session so
the backend is initialised with 8 host devices (used by the sharding tests).
Tests marked ``gpu`` need a CUDA GPU and skip elsewhere; run them on the
card with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -n 0``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run slow closed-loop soak tests (also: RUN_SLOW=1)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW") == "1":
        return
    if "slow" in (config.getoption("-m") or ""):
        return  # explicit -m selection overrides the default skip
    skip = pytest.mark.skip(
        reason="slow soak: pass --runslow (or RUN_SLOW=1, or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)
