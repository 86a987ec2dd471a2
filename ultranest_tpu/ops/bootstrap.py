# noqa: D400 D205
"""
Bootstrapped region radius / ellipsoid enlargement
--------------------------------------------------

Device replacement for the reference's bootstrap loop
(`/root/reference/ultranest/mlfriends.pyx:1017-1070`, `:1392-1440`,
`:1501-1548`, `:1569-1597`): B rounds of "select a random subset of live
points, wrap them, measure how far the *unselected* points stick out".

Work split:

* the O(B N^2 d) radius part runs on device — the N x N whitened-space
  distance matrix is computed **once** and every bootstrap round is a
  masked min/max reduction over it, i.e. O(N^2 d + B N^2) instead of
  the reference's per-round O(B N^2 d); small problems run on the host
  (see ``CPU_WORK_THRESHOLD``);
* the ellipsoid enlargement rounds (B x (N d^2 + d^3) flops — tiny) are
  batched host numpy in f64: einsum covariance per mask, batched inverse,
  batched Mahalanobis. This keeps the linear algebra in f64 and out of
  the device compile path while still vectorizing over all rounds,
  unlike the reference's python loop.

Numerical failures (the reference raises LinAlgError /
FloatingPointError) surface as a validity flag / exception for the host
logic to act on.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from .pairwise import pairwise_sqdist, pad_rows, round_up

__all__ = ['bootstrap_radius_enlargement', 'make_bootstrap_masks']

# numpy scalar on purpose — see ops/pairwise.py:BIG
BIG = np.float32(1e30)

# Total masked-reduction work (padded pairwise cells x rounds) below
# which the radius kernel is compiled for and run on the local CPU
# backend instead of the default accelerator: a small bootstrap cannot
# amortize the accelerator's dispatch and fetch (~1 ms). Measured with
# ``tests/benchmark_maxradius.py --crossover`` on one NVIDIA H100 80GB
# HBM3 (400 W limit), 30 rounds: XLA:CPU won at 0.49M (N=128), the GPU
# at 1.97M (N=256) and above. Set to 0 to always use the default
# backend.
CPU_WORK_THRESHOLD = int(os.environ.get(
    'ULTRANEST_TPU_BOOTSTRAP_CPU_MAX', 1_000_000))


def _cpu_device():
    """A process-local host jax device, or None when the platform pin
    excludes it (must be local: in multi-controller jobs
    ``jax.devices('cpu')[0]`` may belong to another process)."""
    try:
        for d in jax.local_devices(backend='cpu'):
            return d
        return None
    except RuntimeError:
        return None


def make_bootstrap_masks(n, nbootstraps, rng=np.random):
    """Draw bootstrap selection masks on the host RNG.

    Each round selects the *set* of points hit by n draws-with-replacement
    (multiplicity ignored, as in the reference). Degenerate rounds
    (all / none selected) are dropped, mirroring the reference's
    `continue`.

    Returns
    -------
    masks: bool array (nrounds, n)
    """
    masks = np.zeros((nbootstraps, n), dtype=bool)
    # one (B, n) draw consumes the same RandomState stream as B
    # sequential size-n draws (row-major fill), so masks are
    # bit-identical to the per-round loop
    idx = rng.randint(n, size=(nbootstraps, n))
    np.put_along_axis(masks, idx, True, axis=1)
    keep = ~(masks.all(axis=1) | ~masks.any(axis=1))
    return masks[keep]


def _scan_radius_rounds(d2, valid, masks):
    """max over rounds of (max over unselected of min dist^2 to selected)."""
    def radius_round(carry, sel):
        d2sel = jnp.where(sel[:, None], d2, BIG)
        mind = jnp.min(d2sel, axis=0)
        outside = jnp.logical_and(valid, ~sel)
        maxd = jnp.max(jnp.where(outside, mind, -BIG))
        return jnp.maximum(carry, maxd), None

    maxd, _ = jax.lax.scan(radius_round, jnp.float32(0.0), masks)
    return maxd


@functools.partial(jax.jit)
def _radius_kernel(tpoints, valid, masks):
    d2 = pairwise_sqdist(tpoints, tpoints)
    return _scan_radius_rounds(d2, valid, masks)


_SHARDED_RADIUS_CACHE = {}


def _radius_kernel_sharded(mesh, axis_name=None):
    """Bootstrap radius with rounds split across the mesh, pmax-merged.

    Mesh equivalent of the reference's MPI bootstrap split
    (`/root/reference/ultranest/integrator.py:375-415`: each rank runs
    nbootstraps/size rounds, allreduce-max of the radius): each shard
    computes its own copy of the distance matrix and scans only its
    rounds; one ``pmax`` crosses the interconnect (hierarchically,
    within a host first, on a tuple-axis mesh).
    """
    if axis_name is None:
        from ..parallel import mesh_axes
        axis_name = mesh_axes(mesh)
    key = (id(mesh), axis_name)
    fn = _SHARDED_RADIUS_CACHE.get(key)
    if fn is None:
        def shard_fn(tpoints, valid, masks):
            local = _scan_radius_rounds(
                pairwise_sqdist(tpoints, tpoints), valid, masks)
            return jax.lax.pmax(local, axis_name)

        fn = jax.jit(jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(axis_name)), out_specs=P(),
            check_vma=False))
        _SHARDED_RADIUS_CACHE[key] = fn
    return fn


def _numpy_radius(tpoints, masks, K=8):
    """Exact host bootstrap radius via a K-nearest-neighbour table.

    The per-round ``d2[sel][:, ~sel].min(axis=0).max()`` loop copies
    O(n^2) per round through two fancy-index passes; with ~63% of
    points selected per round, the nearest *selected* neighbour of an
    unselected point is almost surely among its K=8 nearest overall
    (miss probability 0.37^8 ~ 3e-4), so one shared (n, K) neighbour
    table answers every round with (B, n, K) boolean gathers. Misses
    fall back to the exact column scan. Bit-identical to the loop.
    """
    from .pairwise import _np_sqdist
    n = len(tpoints)
    B = len(masks)
    if B == 0 or n == 0:
        return 0.0
    d2 = _np_sqdist(tpoints, tpoints)
    K = min(K, n)
    # row j of dT holds column j of d2 contiguously: the axis=1
    # partition avoids the strided axis=0 one.
    # (BLAS Gram distances are NOT bit-symmetric, so reading row values
    # as column values would drift by one ulp vs the reference loop.)
    dT = np.ascontiguousarray(d2.T)
    if K < n:
        nbr = np.argpartition(dT, K - 1, axis=1)[:, :K]
    else:
        nbr = np.argsort(dT, axis=1)
    dnbr = np.take_along_axis(dT, nbr, axis=1)  # (n, K), unordered
    selnbr = masks[:, nbr]                      # (B, n, K)
    # min over the selected members of the K-subset: no need to order
    # the neighbours, only the minimum distance matters
    minds = np.where(selnbr, dnbr[None], np.inf).min(axis=2)  # (B, n)
    has = np.isfinite(minds)
    miss_b, miss_j = np.nonzero(~has & ~masks)
    for b, j in zip(miss_b.tolist(), miss_j.tolist()):
        col = d2[masks[b], j]
        minds[b, j] = col.min() if col.size else -np.inf
    minds = np.where(masks, -np.inf, minds)
    return max(0.0, float(minds.max()))


def _bootstrap_radius(tpoints, masks, mesh=None):
    """Device-side bootstrapped MLFriends radius (optionally mesh-sharded)."""
    tpoints = np.asarray(tpoints, dtype=np.float32)
    n = len(tpoints)
    npd = round_up(n)
    valid = pad_rows(np.ones(n, bool), npd, False)
    tp = pad_rows(tpoints, npd)
    nshards = mesh.devices.size if mesh is not None else 1
    if nshards > 1 and len(masks) >= nshards:
        # pad the round count to a multiple of the shard count with
        # all-selected rounds (their unselected set is empty, so they
        # contribute -BIG and never win the max)
        nrounds = -(-len(masks) // nshards) * nshards
        mk = np.ones((nrounds, npd), dtype=bool)
        mk[:len(masks), :n] = masks
        mk[:len(masks), n:] = False
        args = (tp, valid, mk)
        from ..parallel.launch import (fetch_replicated,
                                       is_multiprocess_mesh, put_args)
        if is_multiprocess_mesh(mesh):
            from jax.sharding import PartitionSpec as P
            from ..parallel import mesh_axes
            args = put_args(mesh, (P(), P(), P(mesh_axes(mesh))), args)
        return float(fetch_replicated(_radius_kernel_sharded(mesh)(*args)))
    mk = np.zeros((len(masks), npd), dtype=bool)
    mk[:, :n] = masks
    work = npd * npd * max(len(mk), tpoints.shape[1])
    if work < CPU_WORK_THRESHOLD:
        cpu = _cpu_device()
        if cpu is None:
            # JAX_PLATFORMS pinned to the accelerator only: no host
            # backend to route to — numpy path matching the kernel
            return _numpy_radius(tpoints, masks)
        with jax.default_device(cpu):
            return float(_radius_kernel(tp, valid, mk))
    return float(_radius_kernel(tp, valid, mk))


def _bootstrap_enlargement(u, masks, mode):
    """Host-side batched ellipsoid enlargement over all bootstrap rounds.

    For each round: center+covariance of the selected subset (with the
    (d+2) uniform-ellipsoid inflation for full-covariance modes), then the
    maximum squared Mahalanobis distance of the unselected points.

    All rounds are reduced to BLAS matmuls through the moment identities
    ``var = E[x^2] - E[x]^2`` and ``S = sum x x^T - n c c^T`` instead of
    materializing the (B, N, d) per-round residual tensor that naive
    3-operand einsums would build. ``u`` is centered on its global mean first, which
    bounds the cancellation error of the moment form: coordinates are
    O(spread), so ``E[x^2]`` carries no large constant offset.
    """
    u = np.asarray(u, dtype=np.float64)
    n, ndim = u.shape
    u = u - u.mean(axis=0)                             # cancellation guard
    w = masks.astype(np.float64)                       # (B, N)
    counts = w.sum(axis=1)                             # (B,)
    ctr = (w @ u) / counts[:, None]                    # (B, d)
    u2 = u * u                                         # (N, d)

    if mode == 'simple':
        # axis-aligned: per-axis variance of the selected points.
        # Floor at 1e-30, not the representable limit: with ivar ~1e300
        # the two matmul terms below both overflow to inf and inf-inf
        # yields NaN, silently keeping a stale region upstream. A 1e-30
        # floor keeps m huge-but-finite so a degenerate bootstrap axis
        # degrades the same way the residual form did — by enlarging
        # enormously.
        var = (w @ u2) / counts[:, None] - ctr * ctr   # (B, d)
        var = np.maximum(var, 1e-30)
        ivar = 1.0 / var
        # m_bn = sum_i (u_ni - c_bi)^2 / var_bi, expanded into matmuls
        m = u2 @ ivar.T - 2.0 * (u @ (ctr * ivar).T) \
            + (ctr * ctr * ivar).sum(axis=1)           # (N, B)
        m = m.T
    else:
        # ddof=1 sample covariance, inflated by (d+2):
        # S_b = sum_sel u u^T - counts_b c_b c_b^T via one (B,N)@(N,d^2)
        outer = (u[:, :, None] * u[:, None, :]).reshape(n, ndim * ndim)
        cov = (w @ outer).reshape(-1, ndim, ndim) \
            - counts[:, None, None] * ctr[:, :, None] * ctr[:, None, :]
        cov /= np.maximum(counts - 1, 1)[:, None, None]
        cov *= (ndim + 2)
        try:
            invcov = np.linalg.inv(cov)
        except np.linalg.LinAlgError:
            return np.nan
        # m_bn = (u-c) A (u-c) = uAu - 2 uAc + cAc, batched matmuls
        Au = np.matmul(u, invcov)                      # (B, N, d)
        uAu = np.einsum('bnd,nd->bn', Au, u)
        Ac = np.einsum('bij,bj->bi', invcov, ctr)      # (B, d)
        uAc = u @ Ac.T                                 # (N, B)
        cAc = (ctr * Ac).sum(axis=1)                   # (B,)
        m = uAu - 2.0 * uAc.T + cAc[:, None]

    outside = ~masks
    m = np.where(outside, m, -np.inf)
    maxf = m.max()
    return maxf


def bootstrap_radius_enlargement(upoints, tpoints, masks, mode='mlfriends',
                                 mesh=None):
    """Run all bootstrap rounds.

    Parameters
    ----------
    upoints: array (N, d)
        live points in unit-cube space (ellipsoid space)
    tpoints: array (N, d) or None
        live points in whitened space (MLFriends radius space)
    masks: bool array (B, N)
        bootstrap selection masks from :func:`make_bootstrap_masks`
    mode: str
        'mlfriends' (radius + ellipsoid), 'ellipsoid' (robust ellipsoid
        only), 'simple' (axis-aligned), 'wrap' (wrapping ellipsoid)
    mesh: jax.sharding.Mesh or None
        when given, the O(B N^2) radius rounds are split across the
        mesh and pmax-merged (the ellipsoid rounds stay host-batched —
        they are O(B (N d^2 + d^3)), negligible)

    Returns
    -------
    maxradiussq: float
        MLFriends squared radius (1e300 for ellipsoid-only modes)
    enlarge: float
        squared Mahalanobis enlargement factor
    ok: bool
        False when the computation degenerated (host should keep the old
        region, mirroring the reference's exception path)

    Note: the reference's SimpleRegion enlargement reduces over the wrong
    axis (`mlfriends.pyx:1540`, summing over points rather than
    dimensions); this implementation uses the dimensionally correct
    Mahalanobis sum.
    """
    if len(masks) == 0:
        return 0.0, np.nan, False

    if mode == 'mlfriends':
        maxd = _bootstrap_radius(tpoints, masks, mesh=mesh)
    else:
        maxd = 1e300

    maxf = _bootstrap_enlargement(upoints, masks, mode)

    ok = bool(np.isfinite(maxf) and maxf > 0)
    if mode == 'mlfriends':
        ok = ok and np.isfinite(maxd) and maxd > 0
    return maxd, float(maxf), ok
