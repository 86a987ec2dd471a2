# noqa: D400 D205
"""
Device-side live-set consumption (shared by the segment engines)
----------------------------------------------------------------

The consume scan turns a batch of candidate rows into nested-sampling
insertions ON DEVICE: each valid row above the current worst live point
replaces it (argmin-replace), so the acceptance threshold rises inside
the dispatch exactly as the host tree would raise it. One record per
row is emitted for the host to replay (see
``integrator._explore_segments``).

Used by both device samplers: the population slice walker
(:mod:`ultranest_tpu.popfused`) and the region rejection proposer
(:mod:`ultranest_tpu.fused`).
"""

import jax
import jax.numpy as jnp

__all__ = ['consume_scan', 'pack_segment', 'whitened_jump2',
           'whitened_cloud_var']

# per-row record layout appended after [u, L]:
# [accept, worst_slot, Lmin, rank, flags(plateau*2 + dup)]
# the walk kernels (popfused) append one more column: the whitened
# squared chain travel distance (whitened_jump2)
RECORD_COLS = 5


def whitened_jump2(u0, uf, tpack):
    """Whitened squared travel distance per chain, computed on device.

    ``tpack`` is the (d+1, d) pack built by
    :meth:`popfused.FusedPopulationSliceSampler._pack_whiten`: the
    layer's whitening matrix T (rows 0..d-1) and a trailing 0/1 mask of
    wrapped (circular) dimensions. Wrapped axes use the minimal-image
    delta (period 1 in cube space) so a chain hopping the seam is not
    charged a full period. Shipping this one scalar per row home
    replaces shipping the d chain-start coordinates (halves the record
    payload at d=50).

    The product is pinned to full f32 precision: it feeds the adaptive
    nsteps governor, whose margin (``RELJUMP_MARGIN``) separates biased
    from unbiased chain lengths by a few per cent, more than a
    reduced-precision (TF32, bf16) product can be trusted with.
    """
    delta = uf - u0
    wmask = tpack[-1]
    delta = delta - wmask[None, :] * jnp.round(delta)
    wdelta = jnp.dot(delta, tpack[:-1],
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(wdelta * wdelta, axis=1)


def whitened_cloud_var(live_u, nlive, tpack):
    """Summed per-axis variance of the whitened live cloud, on device.

    The decorrelation normalizer for the jump-distance diagnostics
    (:func:`popstepsampler.reference_sqdistance_info`, cloud-variance
    branch) — computed from the *dispatch-time* device live set rather
    than the host region snapshot. Chained segment dispatches run up to
    queue-depth segments past the last host region rebuild, during
    which the cloud shrinks by ``exp(-consumed / (nlive * ndim))`` per
    axis; normalizing by the stale host variance biased the measured
    GM relative jump low by exactly that factor (measured 1.27 vs the
    true 1.40 on a 12-d problem at queue depth 4, which made the
    adaptive-nsteps governor double without bound).

    ``live_u`` is padded; rows past ``nlive`` are excluded by mask.
    ``tpack`` is the whitening pack of :meth:`popfused._pack_whiten`
    (the same metric the per-chain ``whitened_jump2`` uses, so the
    ratio is scale-consistent even when the whitening itself is stale).
    Full f32 precision, as for :func:`whitened_jump2`.
    """
    w = jnp.dot(live_u, tpack[:-1], preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    m = (jnp.arange(live_u.shape[0]) < nlive).astype(jnp.float32)
    n = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(w * m[:, None], axis=0) / n
    dev = (w - mean[None, :]) * m[:, None]
    return jnp.sum(dev * dev) / n


def consume_scan(live_u, live_L, rows_u, rows_L, rows_valid):
    """Consume candidate rows into the live set; returns records.

    Parameters
    ----------
    live_u: (npad, d) f32
        live points, padded
    live_L: (npad,) f32
        live log-likelihoods, padded with +inf (argmin ignores padding)
    rows_u: (P, d) f32
        candidate coordinates, in draw/walker order
    rows_L: (P,) f32
        candidate log-likelihoods
    rows_valid: (P,) f32
        1.0 where the row is a usable candidate

    Returns
    -------
    live_u2, live_L2, recs: updated live state and (P, 5) records
    """
    # The scan carries ONLY the scalar live values: carrying the
    # (npad, d) coordinate matrix through P sequential steps makes the
    # scan cost scale with npad * d per row.  Coordinates are reconstructed afterwards in
    # one scatter-max pass: a slot's final occupant is the LAST
    # accepted row that replaced it, which is exactly the scan's final
    # state.
    def consume(lL, row):
        L_i, valid_i = row
        worst = jnp.argmin(lL)
        Lmin_i = lL[worst]
        accept = jnp.logical_and(valid_i > 0.5, L_i > Lmin_i)
        rank = jnp.sum(lL < L_i)
        plateau = jnp.sum(lL == Lmin_i) > 1
        dup = jnp.any(lL == L_i)
        lL = jnp.where(accept, lL.at[worst].set(L_i), lL)
        rec = jnp.stack([
            accept.astype(jnp.float32),
            worst.astype(jnp.float32), Lmin_i,
            rank.astype(jnp.float32),
            plateau.astype(jnp.float32) * 2 + dup.astype(jnp.float32)])
        return lL, rec

    live_L2, recs = jax.lax.scan(
        consume, live_L, (rows_L, rows_valid))
    npad = live_L.shape[0]
    P = rows_L.shape[0]
    accept = recs[:, 0] > 0.5
    worst = recs[:, 1].astype(jnp.int32)
    # last accepted row index per slot (scatter-max; rejected rows
    # target a dummy slot past the end)
    slot = jnp.where(accept, worst, npad)
    last_row = jnp.full(npad + 1, -1, jnp.int32).at[slot].max(
        jnp.arange(P, dtype=jnp.int32))[:npad]
    src = jnp.clip(last_row, 0, P - 1)
    live_u2 = jnp.where((last_row >= 0)[:, None], rows_u[src], live_u)
    return live_u2, live_L2, recs


def pack_segment(rows_u, rows_L, recs, nc, done_frac, width,
                 nuseful=None, ref2=None):
    """Pack rows + records + a trailing scalar row into one f32 array.

    ``nuseful`` is the useful-work evaluation count (evaluations a
    strictly sequential sampler would have needed for the same accepted
    chains); engines without speculative evaluation omit it and report
    useful == billed. ``ref2`` is the dispatch-time whitened cloud
    variance (:func:`whitened_cloud_var`); engines without jump
    diagnostics omit it (slot stays 0, the host falls back to the
    region snapshot).
    """
    rows = jnp.concatenate([rows_u, rows_L[:, None], recs], axis=1)
    scalars = jnp.zeros((1, rows.shape[1]), jnp.float32)
    scalars = scalars.at[0, 0].set(nc)
    scalars = scalars.at[0, 1].set(done_frac)
    scalars = scalars.at[0, 2].set(width)
    scalars = scalars.at[0, 3].set(nc if nuseful is None else nuseful)
    if ref2 is not None:
        scalars = scalars.at[0, 4].set(ref2)
    return jnp.concatenate([rows, scalars], axis=0)
