# noqa: D400 D205
"""Nested sampling with JAX (GPU or CPU): Bayesian evidence and posterior samples.

A JAX rebuild of the capabilities of UltraNest
(https://github.com/JohannesBuchner/UltraNest): reactive nested sampling
with MLFriends/ellipsoid regions, population step samplers, warm start,
checkpoint/resume, and mesh-sharded parallelism.
"""

import os as _os

# fixed default location of the persistent compile cache: the checkout
# (the directory holding this package). A fixed path matters, because
# the path is part of the cache key.
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    '.jax_cache')


def _enable_persistent_compile_cache(config=None, environ=_os.environ):
    """Point jax at an on-disk compilation cache.

    Each sampler instance builds fresh jit closures, so without a disk
    cache every process recompiles the same region and walk kernels.
    ``JAX_COMPILATION_CACHE_DIR`` (read by jax itself) wins and is never
    overridden; otherwise the cache lives at
    :data:`DEFAULT_COMPILE_CACHE`. Processes pinned to the CPU backend
    (``JAX_PLATFORMS=cpu``, the test suite) get no default cache:
    XLA:CPU executables are not reliably reloadable across processes.
    """
    if config is None:
        import jax
        config = jax.config
    if not environ.get('JAX_COMPILATION_CACHE_DIR') \
            and config.jax_compilation_cache_dir is None:
        if environ.get('JAX_PLATFORMS', '') == 'cpu':
            return
        config.update('jax_compilation_cache_dir', DEFAULT_COMPILE_CACHE)
    if not environ.get('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS'):
        # persist every program that takes more than a tenth of a
        # second to compile: jax's default threshold (1 s) would leave
        # most per-shape region kernels to be recompiled by every
        # process
        config.update('jax_persistent_cache_min_compile_time_secs', 0.1)


_enable_persistent_compile_cache()

from .integrator import (NestedSampler, ReactiveNestedSampler, read_file,
                         warmstart_from_similar_file)
from .utils import vectorize

__all__ = ['NestedSampler', 'ReactiveNestedSampler', 'read_file',
           'warmstart_from_similar_file', 'vectorize']

__author__ = """distsys-graft"""
__version__ = '0.1.0'
