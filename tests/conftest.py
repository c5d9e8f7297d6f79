"""Test environment: CPU backend with 8 virtual devices.

Must run before the first JAX backend use (SURVEY.md §4.2.4): the tests
run on a deterministic 8-device CPU mesh for the shard_map/psum paths,
whatever accelerator the machine has. An explicit ``JAX_PLATFORMS`` is
kept, so on the card ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu``
runs the ``gpu``-marked tests; without a GPU they skip (``gpu_device``).
The full-width card checks are the phases of ``chip_smoke.py``.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Backends initialize lazily: setting the env before the first device use
# selects the 8-device CPU platform even if jax was already imported.
# Verified by test_env.py.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


def pytest_collection_modifyitems(config, items):
    """Fast tier: ``pytest -m quick`` = everything not marked slow.

    The compile-heavy e2e modules dominate the ~19-min full-suite wall time
    (VERDICT r1 weak #8); iterate on the quick tier, run the full suite
    before committing engine-level changes.
    """
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, never while modules are imported)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
