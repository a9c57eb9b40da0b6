import os
import sys

# smoke tests and benches must see exactly 1 device; ONLY dryrun.py sets the
# 512-device flag.  Exception: the CI multidevice job sets REPRO_MULTIDEVICE
# together with --xla_force_host_platform_device_count so the device-placed
# pool tests exercise real disjoint device groups.
if not os.environ.get("REPRO_MULTIDEVICE"):
    os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# One seed drives every randomized path in the suite: the numpy fixtures
# below (which feed the jnp sampling paths), and — via the @seed decorators
# in the hypothesis-based modules — the hypothesis example generator.  A CI
# failure is reproduced locally by exporting the same PYTEST_SEED; nothing
# randomized is allowed to fall back to wall-clock entropy.
PYTEST_SEED = int(os.environ.get("PYTEST_SEED", "0"))

try:  # hypothesis is a dev dependency (requirements-dev.txt), not a runtime one
    from hypothesis import HealthCheck, settings

    _suppress = [HealthCheck.too_slow, HealthCheck.data_too_large,
                 HealthCheck.filter_too_much]
    # "fast" is the tier-1 default: few examples, no deadline (jit compiles
    # blow any per-example deadline).  "slow" is the nightly/slow-job
    # profile: the differential harness widens its search.
    settings.register_profile("fast", max_examples=8, deadline=None,
                              suppress_health_check=_suppress)
    settings.register_profile("slow", max_examples=40, deadline=None,
                              suppress_health_check=_suppress)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "fast"))
except ImportError:  # pragma: no cover - hypothesis-less environments
    pass


@pytest.fixture(scope="session")
def suite_seed() -> int:
    """The suite-wide seed (PYTEST_SEED env var, default 0)."""
    return PYTEST_SEED


@pytest.fixture
def rng(suite_seed) -> np.random.Generator:
    """A fresh numpy Generator per test, pinned to PYTEST_SEED — use this
    instead of ad-hoc ``np.random.default_rng(<literal>)`` so one env var
    reproduces the whole suite's sampled inputs."""
    return np.random.default_rng(suite_seed)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: slow end-to-end test; deselect with -m 'not slow' "
        "(fast suite targets < 60 s)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without "
        "one")
