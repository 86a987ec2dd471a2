# noqa: D400 D205
"""
Mesh-sharded parallelism (the MPI replacement)
----------------------------------------------

The reference distributes work over MPI ranks with a gather-to-root-then-
broadcast (= allgather) idiom (`/root/reference/ultranest/integrator.py`
call sites listed in SURVEY.md §5.8). Here the same invariant — every
shard holds the full tree and live-point set; only candidate generation
and bootstrap rounds are sharded — is expressed natively over a JAX
device mesh:

* candidate generation + likelihood evaluation: ``shard_map`` over the
  candidate batch axis, ``all_gather`` of results, ``psum`` of call
  counts;
* deterministic per-shard RNG via ``jax.random.fold_in(key, axis_index)``
  (replacing the reference's rank-hashed seeds,
  integrator.py:1239-1251);
* strategy reductions (Llo/Lhi/Nlive_min) via ``pmin``/``pmax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ['make_mesh', 'mesh_axes', 'parallel_propose_evaluate']


def mesh_axes(mesh):
    """All axis names of *mesh*: a single name (1-axis) or a tuple.

    The framework shards work over EVERY mesh axis — a 2-axis
    ``('hosts', 'ranks')`` mesh simply presents more workers; jax
    collectives accept the tuple directly and XLA decomposes them
    hierarchically (within a host first, then across hosts). This
    helper is the one place the "shard over all axes" rule is encoded.
    """
    names = mesh.axis_names
    return names[0] if len(names) == 1 else tuple(names)


def make_mesh(n_devices=None, axis_name='ranks', shape=None):
    """Build a device mesh over the first *n_devices* devices.

    Raises if fewer than *n_devices* are available — silently shrinking
    the mesh would make multi-shard tests pass without testing anything.

    Parameters
    ----------
    n_devices: int or None
        number of devices (default: all).
    axis_name: str or tuple of str
        mesh axis name(s); a tuple requires a matching *shape*.
    shape: tuple of int or None
        multi-axis mesh shape, e.g. ``(2, 4)`` with
        ``axis_name=('hosts', 'ranks')`` models 2 hosts x 4 GPUs
        (outer axis = slow interconnect). ``prod(shape)`` devices used.
    """
    devices = jax.devices()
    if shape is not None:
        if np.isscalar(axis_name) or isinstance(axis_name, str):
            raise ValueError('a multi-axis shape needs a tuple axis_name')
        if len(shape) != len(axis_name):
            raise ValueError('shape %r / axis_name %r length mismatch'
                             % (shape, axis_name))
        n_devices = int(np.prod(shape))
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            'requested a %d-device mesh but only %d jax device(s) are '
            'available (platform=%s); set '
            'XLA_FLAGS=--xla_force_host_platform_device_count=%d with '
            'JAX_PLATFORMS=cpu for a virtual mesh'
            % (n_devices, len(devices), devices[0].platform, n_devices))
    if shape is not None:
        return Mesh(np.array(devices[:n_devices]).reshape(shape),
                    tuple(axis_name))
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


def parallel_propose_evaluate(mesh, loglike, transform, x_dim,
                              ndraw_per_shard=128, axis_name=None):
    """Build a sharded propose+evaluate function.

    Each shard draws its own candidates inside the enlarged wrapping
    ellipsoid with a ``fold_in``-derived key, filters and evaluates them,
    then results are allgathered and call counts psum-reduced — the
    mesh equivalent of the reference's per-rank candidate generation
    with gather+bcast merge (integrator.py:1916-1933).

    Returns a jitted function
    ``f(key, ell_ctr, ell_axes_T, ell_invcov, enlarge, Lmin)
    -> (u, v, logl, accepted, ncall)`` with fully replicated outputs.
    """
    if axis_name is None:
        axis_name = mesh_axes(mesh)
    nshards = mesh.devices.size

    def shard_fn(key, ell_ctr, ell_axes_T, ell_invcov, enlarge, Lmin):
        key = jax.random.fold_in(key[0], jax.lax.axis_index(axis_name))
        kdir, krad = jax.random.split(key)
        z = jax.random.normal(kdir, (ndraw_per_shard, x_dim), jnp.float32)
        z = z / jnp.linalg.norm(z, axis=1, keepdims=True)
        r = jax.random.uniform(krad, (ndraw_per_shard, 1),
                               jnp.float32) ** (1.0 / x_dim)
        offs = z * r * jnp.sqrt(enlarge)
        u = ell_ctr[None, :] + jnp.dot(offs, ell_axes_T,
                                       preferred_element_type=jnp.float32,
                                       precision=jax.lax.Precision.HIGHEST)
        in_cube = jnp.logical_and(u > 0, u < 1).all(axis=1)
        d = u - ell_ctr[None, :]
        m = jnp.einsum('ij,jk,ik->i', d, ell_invcov, d,
                       precision=jax.lax.Precision.HIGHEST)
        member = jnp.logical_and(in_cube, m <= enlarge)

        v = transform(u)
        logl = jnp.where(member, loglike(v), -jnp.inf)
        accepted = jnp.logical_and(member, logl > Lmin)
        ncall = jax.lax.psum(jnp.sum(member), axis_name)

        u_all = jax.lax.all_gather(u, axis_name, tiled=True)
        v_all = jax.lax.all_gather(v, axis_name, tiled=True)
        logl_all = jax.lax.all_gather(logl, axis_name, tiled=True)
        acc_all = jax.lax.all_gather(accepted, axis_name, tiled=True)
        return u_all, v_all, logl_all, acc_all, ncall

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis_name), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()), check_vma=False)
    return jax.jit(mapped)
