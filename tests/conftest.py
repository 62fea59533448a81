"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Unit tests are hermetic and run on the CPU: 8 virtual devices exercise the
multi-device sharding paths (SURVEY.md §4 implication list), and Pallas
kernels run in interpret mode.  ``jax.config.update`` before first backend
use pins the platform even where a GPU is present.

Tests that need the card carry the ``gpu`` marker (registered in
``pyproject.toml``) and take the ``gpu_device`` fixture, which decides at
run time whether a card is present and skips with a reason where there is
none.  Run them on a machine with the card by
``EXP_LDPC_TPU_TEST_GPU=1 python -m pytest tests/ -m gpu``; the GPU end to
end check is ``python chip_smoke.py``.
"""
import os

import pytest

_ON_GPU = bool(os.environ.get("EXP_LDPC_TPU_TEST_GPU"))

if not _ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# hermetic: no persistent compile cache written by the test run
os.environ.setdefault("EXP_LDPC_TPU_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: decided when the test runs, never at
    import (every xdist worker must collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with EXP_LDPC_TPU_TEST_GPU=1 on the card)")
    return devs[0]
