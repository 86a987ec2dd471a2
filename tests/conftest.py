"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU backend with 8 virtual devices, which exercises
the multi-device sharding paths without a GPU. ``JAX_PLATFORMS`` set by
the caller wins (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
runs the GPU-marked tests on the card). Flags must be set before the
jax backend initializes.
"""
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
xla_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in xla_flags:
    os.environ['XLA_FLAGS'] = (
        xla_flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
