"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding correctness is validated on a fake 8-device CPU platform.
JAX_PLATFORMS defaults to cpu; the tests marked `gpu` need an NVIDIA
GPU and skip elsewhere (`python chip_smoke.py` runs them on the card
with JAX_PLATFORMS empty).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# XLA:CPU's O3 pipeline is compile-heavy and, for this engine's
# scan+checkpoint programs, actually SLOWER at runtime than O1
# (measured on the tiny engine problem: compile 33.7 s -> 19.6 s,
# steady cycle 3.96 s -> 2.26 s). Tests assert numerics against
# tolerance-based goldens, which hold at either level.
if "xla_backend_optimization_level" not in flags:
    flags = (flags + " --xla_backend_optimization_level=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Persistent compile cache: the engine programs take tens of seconds
# of XLA:CPU compilation each; repeat suite runs skip them entirely.
# An outside JAX_COMPILATION_CACHE_DIR wins; otherwise the cache is
# host-fingerprinted (CPU AOT entries from another machine can crash
# on load, mhmocap/cache.py).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    from mhmocap.cache import cpu_cache_dir  # noqa: E402
    jax.config.update("jax_compilation_cache_dir", cpu_cache_dir(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="also run tests marked 'slow' (full tier; default runs "
             "the fast tier only)")
    parser.addoption(
        "--isolated-in-proc", action="store_true", default=False,
        help="internal: run tests marked 'isolated' directly in this "
             "process (used by the test_spmd_isolated.py subprocess; "
             "see that module's docstring for why they cannot share a "
             "long-lived pytest process)")


def pytest_collection_modifyitems(config, items):
    full = config.getoption("--full")
    in_proc = config.getoption("--isolated-in-proc")
    skip_slow = pytest.mark.skip(
        reason="slow tier: pass --full to include")
    skip_iso = pytest.mark.skip(
        reason="runs in the test_spmd_isolated.py subprocess "
               "(pass --isolated-in-proc to force in-process)")
    for item in items:
        if not full and "slow" in item.keywords:
            item.add_marker(skip_slow)
        elif "isolated" in item.keywords and not in_proc:
            item.add_marker(skip_iso)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU (decided
    here, at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)


@pytest.fixture(scope="session")
def tiny_smpl():
    """Small synthetic SMPL model for fast unit tests."""
    from mhmocap.models.synthetic import make_synthetic_smpl
    return make_synthetic_smpl(num_vertices=512, seed=0)


@pytest.fixture(scope="session")
def full_smpl():
    """Full-size synthetic SMPL model (6890 verts)."""
    from mhmocap.models.synthetic import make_synthetic_smpl
    return make_synthetic_smpl(seed=0)
