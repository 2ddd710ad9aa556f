# NOTE: deliberately no --xla_force_host_platform_device_count here (the
# brief requires smoke tests to see 1 device). Multi-device behaviour is
# exercised by the subprocess scripts under tests/distributed/.
#
# ONE opt-in exception: the CI pod-conformance leg sets
# REPRO_CONFORMANCE_TOPO=pod, which needs real ring peers for the
# flat-vs-hierarchical emission checks in tests/test_topology.py — that
# leg (and only that leg) forces 4 host devices, and only when the
# caller has not pinned XLA_FLAGS itself.
import os
import sys

if os.environ.get("REPRO_CONFORMANCE_TOPO") == "pod" \
        and "XLA_FLAGS" not in os.environ:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root: makes the benchmarks/ package importable (autotune smoke test)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with a reason when "
        "torch.cuda.is_available() is False")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)
