"""Test configuration: force an 8-virtual-device CPU platform BEFORE the
first jax backend use, so sharding/collective logic is exercised without
several GPUs.

The platform is set with ``jax.config.update`` as well as the usual
environment variable (backend init is lazy, so this takes effect as long
as no device has been touched yet). Tests that need a GPU carry the
``gpu`` marker and skip here; ``python chip_smoke.py`` runs the main path
on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)
