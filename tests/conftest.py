"""Test configuration: force the CPU backend with 8 virtual devices.

Parity tests run in float64 on CPU (the reference's golden numbers are CPU
doubles); multi-device sharding tests use the 8 virtual CPU devices, the
JAX way of testing distributed code without a cluster (SURVEY.md §4).
Tests marked ``gpu`` skip here; chip_smoke.py runs them on the card.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

# Vendored fixtures (SURVEY.md §4: golden data lifted verbatim — it is
# data, not code); the suite is self-contained without the reference.
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (the >30 s tail; the full round "
        "gate). Default runs are the fast tier, the analog of the "
        "reference's `make fasttest` (Makefile:17-21).",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >30 s wall; excluded by default, run with --runslow"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips without one); chip_smoke.py "
        "runs these on the card"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow tier; pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def data_dir():
    return DATA
