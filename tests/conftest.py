"""Shared pytest configuration.

Two jobs:

1. The property-test modules need ``hypothesis``, which is not part of the
   runtime environment everywhere. When it is absent, skip *collecting*
   those modules instead of erroring the whole run (install
   ``requirements-dev.txt`` to run them; CI runs them all in a dedicated
   property lane, see .github/workflows/ci.yml).
2. Register the ``slow`` marker used by the long-running training/serving
   smoke tests, so CI can run ``-m "not slow"`` under a wall-clock budget,
   and the ``chaos`` marker for the fault-injection/recovery matrix
   (``pytest -m chaos`` is CI's dedicated reliability lane).
"""
import importlib.util

# Keep in sync with the `property` job in .github/workflows/ci.yml.
PROPERTY_TEST_MODULES = [
    "test_dsss.py",
    "test_engine_strategies.py",
    "test_iomodel_property.py",
    "test_kernels_dsss_spmv.py",
    "test_kernels_flash_attention.py",
    "test_packed_kernel_property.py",
    "test_packed_tiling_property.py",
    "test_reliability_property.py",
    "test_residency_property.py",
    "test_selective_property.py",
    "test_storage_property.py",
    "test_substrate.py",
]

collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    collect_ignore += PROPERTY_TEST_MODULES


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running training/serving smoke tests (deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection / crash-resume / degraded-read recovery matrix "
        "(select with -m chaos)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the repro_torch kernels); skips without one",
    )
