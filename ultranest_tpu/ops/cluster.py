# noqa: D400 D205
"""
Friends-of-friends clustering
-----------------------------

Device replacement for the reference's iterative cluster-growing loop
(`/root/reference/ultranest/mlfriends.pyx:275-384`). Two points belong to
the same cluster iff they are connected through pairs closer than the
MLFriends radius — i.e. connected components of the r-neighbourhood
graph.

The O(N^2 d) adjacency comes from one distance pass on device; the
component labeling itself is a tiny graph problem solved on the host
(union-find via scipy.sparse.csgraph). A pure-device pointer-jumping
label propagation (`lax.while_loop`) is provided as an alternative for
fully fused pipelines.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .pairwise import (_np_sqdist, _small, pairwise_sqdist, pad_rows,
                       round_up)

__all__ = ['connected_components', 'label_propagation_components']


@jax.jit
def _adjacency(tpoints, valid, radiussq):
    d2 = pairwise_sqdist(tpoints, tpoints)
    adj = d2 <= radiussq
    return jnp.logical_and(adj, jnp.logical_and(valid[:, None],
                                                valid[None, :]))


def connected_components(tpoints, radiussq):
    """Connected components of the radius graph over *tpoints*.

    Parameters
    ----------
    tpoints: array (N, d)
        points (whitened space)
    radiussq: float
        connection threshold on squared distance

    Returns
    -------
    labels: int array (N,)
        component label per point (0-based, arbitrary order); renumbering
        and old-id matching is host-side policy
        (:func:`ultranest_tpu.mlfriends.update_clusters`).
    """
    import scipy.sparse
    import scipy.sparse.csgraph
    tpoints = np.asarray(tpoints, dtype=np.float32)
    n = len(tpoints)
    if _small(n, n, tpoints.shape[1]):
        # size-aware routing: the adjacency of a few hundred points
        # computes on the host faster than one device round trip
        # (HOST_WORK_THRESHOLD)
        adj = _np_sqdist(tpoints, tpoints) <= radiussq
    else:
        npd = round_up(n)
        valid = pad_rows(np.ones(n, bool), npd, False)
        adj = np.asarray(_adjacency(pad_rows(tpoints, npd), valid,
                                    jnp.float32(radiussq)))[:n, :n]
    _, labels = scipy.sparse.csgraph.connected_components(
        scipy.sparse.csr_matrix(adj), directed=False)
    # canonicalize: label = smallest member index of the component
    first = np.full(labels.max() + 1, -1, dtype=np.int64)
    for i, lab in enumerate(labels):
        if first[lab] < 0:
            first[lab] = i
    return first[labels]


@jax.jit
def _label_propagation(tpoints, valid, radiussq):
    n = tpoints.shape[0]
    d2 = pairwise_sqdist(tpoints, tpoints)
    adj = d2 <= radiussq
    vmat = jnp.logical_and(valid[:, None], valid[None, :])
    adj = jnp.logical_and(adj, vmat)
    adj = jnp.logical_or(adj, jnp.logical_and(
        jnp.eye(n, dtype=bool), vmat))

    init = jnp.where(valid, jnp.arange(n), n)

    def cond(state):
        labels, changed = state
        return changed

    def body(state):
        labels, _ = state
        neigh = jnp.where(adj, labels[None, :], n)
        new = jnp.minimum(labels, jnp.min(neigh, axis=1))
        # pointer jumping: adopt the label of my current representative
        rep = jnp.where(new < n, new, 0)
        new = jnp.minimum(new, jnp.where(new < n, labels[rep], n))
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return labels


def label_propagation_components(tpoints, radiussq):
    """Fully on-device components via pointer-jumping label propagation.

    Same result as :func:`connected_components` (labels are smallest
    member indices); useful inside fused device pipelines.
    """
    tpoints = np.asarray(tpoints, dtype=np.float32)
    n = len(tpoints)
    npd = round_up(n)
    valid = pad_rows(np.ones(n, bool), npd, False)
    labels = _label_propagation(pad_rows(tpoints, npd), valid,
                                jnp.float32(radiussq))
    return np.asarray(labels)[:n]
