# noqa: D400 D205
"""
Pairwise-distance kernels
-------------------------

Device equivalents of the reference Cython kernels
(`/root/reference/ultranest/mlfriends.pyx:31-270`): nearest-neighbour
queries and radius reductions over live-point sets.

Design: squared distances accumulate by direct differences
(:func:`pairwise_sqdist`); reductions are masked so all shapes stay
static under jit. Host-facing wrappers accept numpy and handle padding.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    'pairwise_sqdist', 'compute_maxradiussq', 'count_nearby', 'find_nearby',
    'compute_mean_pair_distance', 'subtract_nearby', 'pad_rows',
    'round_up',
]

# plain numpy scalar: a module-level jnp constant would initialise the
# XLA backend at import time, breaking jax.distributed.initialize()
BIG = np.float32(1e30)

# Work threshold (pairwise-matrix cells x dims) below which the host
# numpy path beats a device dispatch: upload, dispatch and fetch cost
# the device path a fixed ~0.7-1.4 ms, which a small problem cannot
# amortize. Measured with ``tests/benchmark_maxradius.py --crossover``
# on one NVIDIA H100 80GB HBM3 (400 W limit): the host won every case
# at <= 131k, the device every case at >= 8.4M and two of three at
# 2.1M. Large problems always go to the device. Set to 0 to force the
# device path (used by tests).
HOST_WORK_THRESHOLD = int(os.environ.get(
    'ULTRANEST_TPU_HOST_KERNEL_THRESHOLD', 2_000_000))


def _small(na, nb, d):
    """Whether a pairwise problem is too small to ship to the device."""
    return na * nb * max(d, 1) < HOST_WORK_THRESHOLD


def _np_sqdist(a, b):
    """Host pairwise squared distances (f64 Gram identity).

    f64 keeps the Gram cancellation error (~eps * |a||b|) far below the
    smallest distances nested sampling produces (shrunk regions have
    squared radii down to ~1e-12 of the norm scale).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ra = np.einsum('ij,ij->i', a, a)
    rb = np.einsum('ij,ij->i', b, b)
    g = a @ b.T
    # in-place with the exact same operation order (bit-identical to
    # the naive expression): two allocations instead of four — fresh
    # page faults dominate this routine at rebuild shapes (~n=400)
    g *= 2.0
    t = ra[:, None] + rb[None, :]
    np.subtract(t, g, out=t)
    np.maximum(t, 0.0, out=t)
    return t


def round_up(n, base=64):
    """Round *n* up to the next power of two, at least *base*.

    Power-of-two shape buckets keep the number of distinct jit
    compilations logarithmic in the problem size.
    """
    n = max(int(n), base)
    return 1 << (n - 1).bit_length()


def pad_rows(x, npad, fill=0.0):
    """Pad array *x* along axis 0 to *npad* rows with *fill*."""
    x = np.asarray(x)
    n = x.shape[0]
    if n == npad:
        return x
    pad_width = [(0, npad - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def pairwise_sqdist(a, b):
    """Squared euclidean distances between row sets *a* (n,d) and *b* (m,d).

    Computed by direct differences, accumulated per axis in a static
    loop (``d`` is a trace-time constant). The Gram-matrix identity
    (`|a|^2+|b|^2-2ab`) would be a matrix product, but in f32 its
    cancellation error (~1e-7 * norm^2) swamps the tiny squared
    distances late-stage nested sampling regions produce (clusters 1e-5
    wide inside an O(1) whitened cloud — see the eggboxregion golden
    test). Subtracting nearby f32 values is exact (Sterbenz), so the
    direct form keeps full relative precision at O(n*m*d) elementwise
    work. Unrolled, the loop is one elementwise chain that XLA fuses
    with its consumer (compare, mask, reduce), so the (n, m)
    accumulator need not pass through device memory once per axis as a
    ``lax.scan`` carry would.
    """
    d2 = jnp.zeros((a.shape[0], b.shape[0]), jnp.float32)
    for k in range(a.shape[1]):
        diff = a[:, k][:, None] - b[:, k][None, :]
        d2 = d2 + diff * diff
    return d2


@functools.partial(jax.jit)
def _maxradius_masked(apts, amask, bpts, bmask):
    """max over valid b of (min over valid a of ||a-b||^2)."""
    d2 = pairwise_sqdist(apts, bpts)
    d2 = jnp.where(amask[:, None], d2, BIG)
    mind = jnp.min(d2, axis=0)
    return jnp.max(jnp.where(bmask, mind, -BIG))


def compute_maxradiussq(apts, bpts):
    """Worst-case nearest-neighbour squared distance from *bpts* to *apts*.

    Equivalent to the reference kernel `mlfriends.pyx:188-224`: for each
    point in *bpts* find the squared distance to its nearest point in
    *apts*; return the maximum.
    """
    apts = np.asarray(apts, dtype=np.float32)
    bpts = np.asarray(bpts, dtype=np.float32)
    na, nb = len(apts), len(bpts)
    if _small(na, nb, apts.shape[1]):
        return float(_np_sqdist(apts, bpts).min(axis=0).max())
    npa, npb = round_up(na), round_up(nb)
    amask = pad_rows(np.ones(na, bool), npa, False)
    bmask = pad_rows(np.ones(nb, bool), npb, False)
    out = _maxradius_masked(pad_rows(apts, npa), amask,
                            pad_rows(bpts, npb), bmask)
    return float(out)


@functools.partial(jax.jit, static_argnames=('count',))
def _nearby_masked(apts, amask, bpts, radiussq, count):
    """Count (or find first index of) valid a-points within radius of each b."""
    d2 = pairwise_sqdist(apts, bpts)
    within = jnp.logical_and(d2 <= radiussq, amask[:, None])
    if count:
        return jnp.sum(within, axis=0).astype(jnp.int32)
    # first matching index, -1 if none (argmax returns first True)
    anyhit = jnp.any(within, axis=0)
    first = jnp.argmax(within, axis=0)
    return jnp.where(anyhit, first, -1).astype(jnp.int32)


def _nearby_host(apts, bpts, radiussq, count):
    apts = np.asarray(apts, dtype=np.float32)
    bpts = np.asarray(bpts, dtype=np.float32)
    na, nb = len(apts), len(bpts)
    if na == 0 or nb == 0:
        return np.full(nb, 0 if count else -1, dtype=np.int64)
    if _small(na, nb, apts.shape[1]):
        within = _np_sqdist(apts, bpts) <= radiussq
        if count:
            return within.sum(axis=0).astype(np.int64)
        first = within.argmax(axis=0)
        return np.where(within.any(axis=0), first, -1).astype(np.int64)
    npa, npb = round_up(na), round_up(nb)
    amask = pad_rows(np.ones(na, bool), npa, False)
    out = _nearby_masked(pad_rows(apts, npa), amask,
                         pad_rows(bpts, npb, fill=1e5),
                         jnp.float32(radiussq), count)
    return np.asarray(out)[:nb]


def count_nearby(apts, bpts, radiussq, nnearby=None):
    """Number of *apts* within sqrt(radiussq) of each point in *bpts*.

    Mirrors `mlfriends.pyx:31-68`; if *nnearby* is given, results are also
    written into it (reference out-parameter convention).
    """
    out = _nearby_host(apts, bpts, radiussq, count=True)
    if nnearby is not None:
        nnearby[:] = out
    return out


def find_nearby(apts, bpts, radiussq, nnearby=None):
    """Index of some *apts* member within sqrt(radiussq) of each *bpts* point.

    -1 where none is within reach (cf. `mlfriends.pyx:143-183`).
    """
    out = _nearby_host(apts, bpts, radiussq, count=False)
    if nnearby is not None:
        nnearby[:] = out
    return out


@jax.jit
def _mean_pair_distance_masked(pts, clusterids):
    d2 = pairwise_sqdist(pts, pts)
    same = clusterids[:, None] == clusterids[None, :]
    valid = jnp.logical_and(same, (clusterids > 0)[:, None])
    # strict upper triangle: each unordered pair once
    n = pts.shape[0]
    iu = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    ju = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    valid = jnp.logical_and(valid, iu < ju)
    dist = jnp.sqrt(d2)
    total = jnp.sum(jnp.where(valid, dist, 0.0))
    npairs = jnp.sum(valid)
    return total, npairs


def compute_mean_pair_distance(pts, clusterids=None):
    """Mean distance between point pairs sharing a cluster id (> 0).

    Cf. `mlfriends.pyx:229-270`.
    """
    pts = np.asarray(pts, dtype=np.float32)
    n = len(pts)
    if clusterids is None:
        clusterids = np.ones(n, dtype=np.int64)
    npd = round_up(n)
    cid = pad_rows(np.asarray(clusterids, dtype=np.int64), npd, fill=-1)
    total, npairs = _mean_pair_distance_masked(pad_rows(pts, npd), cid)
    npairs = int(npairs)
    assert npairs > 0, "no pairs share a cluster"
    return float(total) / npairs


@jax.jit
def _subtract_nearby_masked(pts, mask, radiussq):
    d2 = pairwise_sqdist(pts, pts)
    within = jnp.logical_and(d2 <= radiussq, mask[None, :])
    within = jnp.logical_and(within, mask[:, None])
    counts = jnp.sum(within, axis=1)
    # neighbourhood means via one matrix product: adjacency @ pts
    sums = jnp.dot(within.astype(pts.dtype), pts,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    means = sums / jnp.maximum(counts, 1)[:, None]
    return pts - means


def subtract_nearby(upoints, maxradiussq):
    """Subtract from each point the mean of points within the radius.

    This is the local co-centering used by ``LocalAffineLayer``
    (cf. `mlfriends.pyx:73-138`).
    """
    upoints = np.asarray(upoints, dtype=np.float32)
    n = len(upoints)
    if _small(n, n, upoints.shape[1]):
        within = _np_sqdist(upoints, upoints) <= maxradiussq
        counts = np.maximum(within.sum(axis=1), 1)
        means = (within.astype(np.float32) @ upoints) / \
            counts[:, None].astype(np.float32)
        return (upoints - means).astype(float)
    npd = round_up(n)
    mask = pad_rows(np.ones(n, bool), npd, False)
    out = _subtract_nearby_masked(pad_rows(upoints, npd), mask,
                                  jnp.float32(maxradiussq))
    return np.asarray(out)[:n].astype(float)


@jax.jit
def _cluster_counts_masked(apts, amask, onehot, bpts, radiussq):
    d2 = pairwise_sqdist(apts, bpts)
    within = jnp.logical_and(d2 <= radiussq, amask[:, None])
    # per-cluster membership counts via one matrix product:
    # (ncl, Na) x (Na, Nb) -> (ncl, Nb)
    return jnp.dot(onehot.T, within.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def match_clusters(apts, clusterids, bpts, radiussq):
    """For each point in *bpts*: which clusters of *apts* are within reach.

    One device dispatch replaces the reference's per-cluster find_nearby
    loop (integrator.py:2034-2049). Cluster id 0 (unassigned) is ignored.

    Returns
    -------
    new_ids: int array (len(bpts),)
        the cluster id when exactly one cluster is within sqrt(radiussq),
        0 when none or several (ambiguous points stay unassigned).
    """
    apts = np.asarray(apts, dtype=np.float32)
    bpts = np.asarray(bpts, dtype=np.float32)
    clusterids = np.asarray(clusterids)
    na, nb = len(apts), len(bpts)
    ids = np.unique(clusterids[clusterids > 0])
    if len(ids) == 0 or na == 0 or nb == 0:
        return np.zeros(nb, dtype=np.int64)
    if _small(na, nb, apts.shape[1]):
        within = _np_sqdist(apts, bpts) <= radiussq
        counts = np.stack([(within[clusterids == ci]).any(axis=0)
                           for ci in ids])
        nhit = counts.sum(axis=0)
        first = counts.argmax(axis=0)
        return np.where(nhit == 1, ids[first], 0).astype(np.int64)
    npa, npb = round_up(na), round_up(nb)
    onehot = np.zeros((npa, len(ids)), dtype=np.float32)
    for k, ci in enumerate(ids):
        onehot[:na, k] = clusterids == ci
    amask = pad_rows(np.ones(na, bool), npa, False)
    counts = _cluster_counts_masked(
        pad_rows(apts, npa), amask, onehot,
        pad_rows(bpts, npb, fill=1e5), jnp.float32(radiussq))
    counts = np.asarray(counts)[:, :nb] > 0
    nhit = counts.sum(axis=0)
    first = counts.argmax(axis=0)
    return np.where(nhit == 1, ids[first], 0).astype(np.int64)
