"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the standard JAX idiom for
testing pjit/shard_map without several cards — SURVEY.md section 4). The
platform is pinned before any backend initializes (conftest imports run
before test modules): the CPU unless JAX_PLATFORMS names another, which
is how the `gpu`-marked tests (tests/test_gpu.py) run on the card.
"""
import os
import sys

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))  # for numpy_oracle import


@pytest.fixture
def rng():
    return np.random.default_rng(0)
