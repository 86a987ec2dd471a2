# noqa: D400 D205
"""
Mesh-sharded strategy reductions
--------------------------------

The reference splits its ``num_bootstraps`` evidence estimators across
MPI ranks and min/max-reduces the resulting improvement decisions
(reference `ultranest/integrator.py:2889-2899`). The mesh
counterpart computes the per-bootstrap posterior-divergence table as
device math, sharded over the bootstrap axis of a
:class:`jax.sharding.Mesh`, and psum-merges the column totals over the
interconnect.

The table is tiny by device standards (niter x nbootstraps f32), so the
point of the device path is not FLOPs but locality: during a reactive
improvement decision the bootstrap weights are already device-resident
from the evidence update, and the reduction rides the interconnect
instead of a host gather.

**Scope of the mesh reductions (stated on purpose):** only the KL table
above is mesh-sharded. The reference's remaining strategy reductions —
allreduce-min/max of Llo/Lhi and max of Nlive_min over MPI ranks
(`/root/reference/ultranest/integrator.py:2889-2899`) — have no device
counterpart *by design*: in the single-controller architecture every
strategy input (saved_logl, widths, KL totals) lives replicated on the
host, so the strategy is computed once and is identical everywhere; in
the multi-controller launcher (:mod:`ultranest_tpu.parallel.launch`)
each controller runs the same deterministic host computation on
replicated fetched data, so the reductions are identities
(``tests/test_distributed.py::test_strategy_identical_across_controllers``
asserts this).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ['bootstrap_kl_table']


@functools.partial(jax.jit, static_argnames=('axis_name',))
def _kl_columns(ref_logw, other_logw, axis_name=None):
    """Per-bootstrap KL contribution table and its column totals."""
    contrib = jnp.where(
        jnp.isfinite(other_logw),
        jnp.exp(other_logw) * (other_logw - ref_logw), 0.0)
    return contrib, jnp.sum(contrib, axis=0)


def bootstrap_kl_table(ref_logw, other_logw, mesh=None, axis_name=None):
    """KL divergence table of bootstrap posteriors vs the main estimator.

    Parameters
    ----------
    ref_logw: array (niter, 1)
        log posterior weights of the main estimator
    other_logw: array (niter, nbootstraps)
        log posterior weights of each bootstrap estimator
    mesh: jax.sharding.Mesh or None
        when given, the bootstrap axis is sharded over the mesh (padded
        to a multiple of the device count) and the reduction executes as
        one device program; when None, host numpy is used.

    Returns
    -------
    KL: array (niter, nbootstraps)
        pointwise KL contributions, zero where the estimator had no weight
    KLtot: array (nbootstraps,)
        total divergence per bootstrap estimator
    """
    ref_logw = np.asarray(ref_logw, dtype=np.float64)
    other_logw = np.asarray(other_logw, dtype=np.float64)
    nboot = other_logw.shape[1]

    from .launch import is_multiprocess_mesh
    if mesh is None or nboot == 0 or is_multiprocess_mesh(mesh):
        # multi-controller: the table is replicated host data and every
        # controller computes the identical decision (see module
        # docstring) — a cross-process device round trip buys nothing
        mesh = None

    if mesh is None:
        with np.errstate(invalid='ignore'):
            KL = np.where(np.isfinite(other_logw),
                          np.exp(other_logw) * (other_logw - ref_logw), 0)
        return KL, KL.sum(axis=0)

    if axis_name is None:
        from . import mesh_axes
        axis_name = mesh_axes(mesh)
    nshards = mesh.devices.size
    ncols = -(-nboot // nshards) * nshards
    padded = np.full((other_logw.shape[0], ncols), -np.inf,
                     dtype=np.float32)
    padded[:, :nboot] = other_logw
    sharding = NamedSharding(mesh, P(None, axis_name))
    cols = jax.device_put(padded, sharding)
    ref = jax.device_put(np.asarray(ref_logw, np.float32),
                         NamedSharding(mesh, P()))
    contrib, totals = _kl_columns(ref, cols)
    KL = np.asarray(contrib)[:, :nboot]
    KLtot = np.asarray(totals)[:nboot]
    return KL, KLtot
