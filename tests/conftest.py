"""Test configuration: JAX on a virtual 8-device CPU mesh, so sharding
tests run without accelerators (SURVEY.md section 4).  Tests that need
a card carry the `gpu` marker and check for one inside a fixture; they
run on the card with `python -m pytest -m gpu tests/`."""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
