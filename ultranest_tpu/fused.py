# noqa: D400 D205
"""
Fused device proposal path
--------------------------

For JAX-traceable likelihood/transform pairs, one jitted device call
performs the entire hot loop of a nested sampling iteration batch:

    draw candidates -> whiten -> region membership (direct distances to
    the live points) -> unit-cube test -> p-space ellipsoid test -> transform
    -> log-likelihood -> threshold acceptance

This replaces the reference's per-candidate host loop
(`/root/reference/ultranest/integrator.py:1773-1837`) with a single
device dispatch per refill; the host only compacts the accepted rows and
does tree bookkeeping. Region geometry is passed as plain arrays each call
(a few KB piggybacked on the dispatch), so live-point updates between
region rebuilds need no extra device traffic.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from .ops.pairwise import pad_rows, pairwise_sqdist, round_up

__all__ = ['FusedRegionSampler']

# proposal method codes (traced, so switching costs no recompile)
METHOD_CUBE = 0         # uniform in the unit cube, filtered
METHOD_ELLIPSOID = 1    # uniform in the enlarged wrapping ellipsoid
METHOD_TBOX = 2         # uniform in the whitened-space bounding box
METHOD_POINTS = 3       # balls around live points, multiplicity-corrected

# method rotation order on starvation: global proposals first, then the
# live-point balls (which track tight multimodal tails best)
METHOD_CYCLE = [METHOD_ELLIPSOID, METHOD_POINTS, METHOD_CUBE, METHOD_TBOX]

# cap on accepted candidates returned per proposal call; generous —
# truncated rows are paid-for likelihood evaluations thrown away, while
# extra transfer rows cost little (the row width is a few floats)
MAX_RETURN = 1024

# process-level jitted-kernel cache: samplers are routinely recreated
# with *textually identical* model closures (repeat runs, calibrator
# nsteps-doubling, warm starts), and every fresh closure costs a full
# re-trace + lowering per shape bucket even when the compiled
# program is byte-identical. Keyed by the model functions' code objects
# + closure cell values, so same-source same-capture functions share
# compiled kernels across instances. LRU-bounded.
_KERNEL_CACHE = {}
_KERNEL_CACHE_MAX = 128


_F32MAX = float(np.finfo(np.float32).max)


def _as_f32(x):
    """Cast to float32 with overflow clipped to ±f32max (warning-free).

    Whitened-space geometry (bbox corners, 1/std scalings, ellipsoid
    radii) can exceed the f32 range when the live set is degenerate
    along an axis; a saturating cast keeps the packed geometry finite.
    """
    a = np.asarray(x, np.float64)
    return np.clip(a, -_F32MAX, _F32MAX).astype(np.float32)


def _cell_key(v, depth=0):
    """Hashable stand-in for one captured closure cell value.

    numpy arrays hash by dtype/shape/contents (capped at 1 MB — model
    closures capture small parameter vectors; anything larger falls
    back to identity), nested functions recurse, containers map
    element-wise.  Raises TypeError/ValueError for anything else
    unhashable so the caller can fall back.
    """
    if depth > 4:
        raise TypeError('closure nesting too deep')
    if isinstance(v, np.ndarray):
        if v.nbytes > (1 << 20):
            raise TypeError('closure array too large to fingerprint')
        return ('nd', v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (tuple, list)):
        return ('seq', type(v).__name__,
                tuple(_cell_key(x, depth + 1) for x in v))
    if callable(v) and hasattr(v, '__code__'):
        return _fn_fingerprint(v, depth + 1)
    hash(v)
    return v


def _fn_fingerprint(fn, depth=0):
    """A hashable identity for *fn* shared by equivalent closures.

    Returns (code, normalized closure-cell values) when every captured
    cell can be fingerprinted (hashable, a numpy array, a nested
    function, or a flat container of those); otherwise falls back to
    the function object itself (per-instance caching).  Without the
    array normalization, model factories that close over parameter
    vectors (e.g. models.asymgauss's centers/sigma) defeated the
    process-level kernel cache and re-traced identical programs on
    every run.
    """
    if fn is None:
        return None
    try:
        cells = tuple(_cell_key(c.cell_contents, depth)
                      for c in (fn.__closure__ or ()))
        return (fn.__code__, cells)
    except Exception:
        return fn


def _device_put_maybe_global(x, mesh):
    """Upload *x* replicated: plain device_put single-controller, a
    global replicated array when *mesh* spans several processes."""
    if mesh is not None:
        from .parallel.launch import is_multiprocess_mesh, put_along_mesh
        if is_multiprocess_mesh(mesh):
            from jax.sharding import PartitionSpec as P
            return put_along_mesh(mesh, P(), np.asarray(x))
    return jax.device_put(x)


def _kernel_cache_get(key, build):
    fn = _KERNEL_CACHE.pop(key, None)
    if fn is None:
        fn = build()
        while len(_KERNEL_CACHE) >= _KERNEL_CACHE_MAX:
            _KERNEL_CACHE.pop(next(iter(_KERNEL_CACHE)))
    _KERNEL_CACHE[key] = fn
    return fn


def _inside_ellipsoid(u, ctr, invcov, enlarge):
    d = u - ctr
    m = jnp.einsum('ij,jk,ik->i', d, invcov, d,
                   precision=jax.lax.Precision.HIGHEST)
    return m <= enlarge


def tregion_geometry(tregion, num_params):
    """(ctr, invcov, enlarge) of a WrappingEllipsoid in FULL p-space.

    The wrapping ellipsoid factors out fixed (zero-variance) dimensions
    (mlfriends.py:645-662, reference mlfriends.pyx:1563-1567); device
    kernels operate on full ``num_params``-vectors, so the variable-dim
    form is embedded with zero inverse-covariance weight on fixed dims.
    The fixed-dim equality check is vacuous on device: proposals go
    through the same transform, which produces the same constant.
    """
    vd = tregion.variable_dims
    if vd is Ellipsis:
        return (_as_f32(tregion.ellipsoid_center),
                _as_f32(tregion.ellipsoid_invcov),
                np.float32(tregion.enlarge))
    idx = np.flatnonzero(vd)
    ctr = np.zeros(num_params, np.float32)
    inv = np.zeros((num_params, num_params), np.float32)
    ctr[idx] = tregion.ellipsoid_center
    inv[np.ix_(idx, idx)] = tregion.ellipsoid_invcov
    return ctr, inv, np.float32(tregion.enlarge)


def _radius_member(t_candidates, tpoints, tmask, maxradiussq):
    """Within MLFriends radius of any valid live point.

    Distances accumulate per axis by direct differences (see
    :func:`ultranest_tpu.ops.pairwise.pairwise_sqdist` for why the Gram
    identity is numerically unusable here); XLA fuses the per-axis
    chain, the compare and the ``any`` into one kernel.
    """
    d2 = pairwise_sqdist(tpoints, t_candidates)
    within = jnp.logical_and(d2 <= maxradiussq, tmask[:, None])
    return jnp.any(within, axis=0)


class FusedRegionSampler:
    """Device-fused candidate proposal for JAX-native models.

    Parameters
    ----------
    loglike: jax function
        (n, num_params) -> (n,) log-likelihood, jax-traceable
    transform: jax function or None
        (n, x_dim) -> (n, num_params) prior transform, jax-traceable
    x_dim: int
        dimensionality
    seed: int
        device RNG seed
    """

    def __init__(self, loglike, transform, x_dim, seed=0, mesh=None,
                 axis_name=None):
        self.loglike = loglike
        self.transform = transform if transform is not None else (lambda u: u)
        self.x_dim = x_dim
        self.key = jax.random.PRNGKey(seed)
        # per-dispatch threefry keys are drawn from a host RNG: a device
        # jax.random.split per launch costs a device dispatch + fetch,
        # pure overhead for an embarrassingly parallel stream
        self._key_rng = np.random.Generator(np.random.PCG64(seed))
        self.mesh = mesh
        if mesh is not None and axis_name is None:
            # shard over every mesh axis (multi-slice meshes present a
            # ('dcn', 'ranks') tuple; collectives take it directly);
            # an explicit axis_name restricts sharding to that axis
            from .parallel import mesh_axes
            axis_name = mesh_axes(mesh)
        elif mesh is None and axis_name is None:
            axis_name = 'ranks'
        self.axis_name = axis_name
        self.nshards = 1 if mesh is None else int(mesh.devices.size)
        self._propose_cache = {}
        self._pending = []
        # dispatches kept in flight ahead of the consumer. Depth 2 hides
        # the dispatch + transfer round trip: while the host consumes
        # buffer k, buffers k+1 and k+2 compute/stream.
        # 0 on the cpu backend — no second processor to overlap with.
        self.prefetch_depth = 0 if jax.default_backend() == 'cpu' else 2

    def _next_key(self, n=None):
        """Fresh threefry key (or *n* keys) from the host RNG stream."""
        shape = (2,) if n is None else (n, 2)
        return self._key_rng.integers(0, 2**32, size=shape,
                                      dtype=np.uint32)

    def _get_propose(self, ndraw, kind, has_tregion, num_params):
        cache_key = (ndraw, kind, has_tregion, num_params)
        fn = self._propose_cache.get(cache_key)
        if fn is None:
            gkey = (_fn_fingerprint(self.loglike),
                    _fn_fingerprint(self.transform), self.x_dim,
                    self.nshards,
                    None if self.mesh is None else id(self.mesh),
                    cache_key)
            fn = _kernel_cache_get(
                gkey, lambda: self._build_packed(ndraw, kind, has_tregion,
                                                 num_params))
            self._propose_cache[cache_key] = fn
        return fn

    def _geom_layout(self, has_tregion, num_params):
        """Static slice layout of the packed geometry vector.

        All region geometry (matrices, vectors, scalars) ships as ONE
        f32 array per dispatch: each argument is its own host-to-device
        transfer, and the classic signature had ~20.
        """
        d = self.x_dim
        p = num_params if has_tregion else 0
        fields = [('T', (d, d)), ('invT', (d, d)), ('ctr', (d,)),
                  ('ell_ctr', (d,)), ('ell_invcov', (d, d)),
                  ('ell_axes_T', (d, d)), ('tbox_lo', (d,)),
                  ('tbox_hi', (d,)), ('treg_ctr', (p,)),
                  ('treg_invcov', (p, p)),
                  # npts, maxradiussq, enlarge, treg_enlarge, Lmin,
                  # method, naccept_budget
                  ('scalars', (7,))]
        layout = {}
        off = 0
        for name, shape in fields:
            n = int(np.prod(shape)) if len(shape) else 1
            layout[name] = (off, shape)
            off += n
        return layout, off

    def _build_packed(self, ndraw, kind, has_tregion, num_params):
        """Jit a proposal kernel taking (key, tpoints, geom) only."""
        layout, _ = self._geom_layout(has_tregion, num_params)
        body = self._make_body(ndraw, kind, has_tregion)
        x_dim = self.x_dim

        def unpack_and_run(key, tpoints, geom):
            def g(name):
                off, shape = layout[name]
                n = int(np.prod(shape)) if len(shape) else 1
                return geom[off:off + n].reshape(shape)

            s = g('scalars')
            npts = s[0].astype(jnp.int32)
            tmask = jnp.arange(tpoints.shape[0]) < npts
            if has_tregion:
                treg_ctr, treg_invcov = g('treg_ctr'), g('treg_invcov')
            else:
                treg_ctr = jnp.zeros(x_dim, jnp.float32)
                treg_invcov = jnp.eye(x_dim, dtype=jnp.float32)
            return body(
                key, tpoints, tmask, npts, g('T'), g('invT'), g('ctr'),
                s[1], g('ell_ctr'), g('ell_invcov'), s[2],
                g('ell_axes_T'), treg_ctr, treg_invcov, s[3],
                g('tbox_lo'), g('tbox_hi'), s[4],
                s[5].astype(jnp.int32), s[6].astype(jnp.int32))

        pack = self._make_pack()
        if self.nshards == 1:
            return jax.jit(lambda *args: pack(*unpack_and_run(*args)))

        from jax.sharding import PartitionSpec as P
        axis_name = self.axis_name

        def shard_fn(keys, tpoints, geom):
            # per-shard deterministic RNG (the fold_in pattern replacing
            # the reference's rank-hashed seeds, integrator.py:1239-1251)
            key = jax.random.fold_in(keys[0],
                                     jax.lax.axis_index(axis_name))
            u, v, logl, n_acc, nc = unpack_and_run(key, tpoints, geom)
            u_all = jax.lax.all_gather(u, axis_name, tiled=True)
            v_all = jax.lax.all_gather(v, axis_name, tiled=True)
            logl_all = jax.lax.all_gather(logl, axis_name, tiled=True)
            n_acc_all = jax.lax.all_gather(n_acc[None], axis_name,
                                           tiled=True)
            nc_tot = jax.lax.psum(nc, axis_name)
            return u_all, v_all, logl_all, n_acc_all, nc_tot

        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(axis_name), P(), P()),
            out_specs=(P(), P(), P(), P(), P()), check_vma=False)
        return jax.jit(lambda *args: pack(*mapped(*args)))

    def _make_body(self, ndraw, kind, has_tregion, segment=False):
        """Closure computing one proposal batch (draw→filter→L→compact)."""
        loglike = self.loglike
        transform = self.transform
        x_dim = self.x_dim
        nshards = self.nshards
        ndraw_local = max(128, ndraw // nshards)
        kreturn = max(16, MAX_RETURN // nshards)

        def body(key, tpoints, tmask, nlive, T, invT, ctr, maxradiussq,
                    ell_ctr, ell_invcov, enlarge, ell_axes_T,
                    treg_ctr, treg_invcov, treg_enlarge, tbox_lo, tbox_hi,
                    Lmin, method, naccept_budget):
            kdraw, kdir, krad, kidx, kmult = jax.random.split(key, 5)
            ones = jnp.ones(ndraw_local, bool)

            def ball_offsets(scale):
                z = jax.random.normal(kdir, (ndraw_local, x_dim), jnp.float32)
                z = z / jnp.linalg.norm(z, axis=1, keepdims=True)
                r = jax.random.uniform(krad, (ndraw_local, 1),
                                       jnp.float32) ** (1.0 / x_dim)
                return z * r * scale

            def draw_cube(_):
                return jax.random.uniform(kdraw, (ndraw_local, x_dim),
                                          jnp.float32), ones

            def draw_ellipsoid(_):
                offs = ball_offsets(jnp.sqrt(enlarge))
                return ell_ctr[None, :] + jnp.dot(
                    offs, ell_axes_T,
                    preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST), ones

            def draw_tbox(_):
                v = jax.random.uniform(kdraw, (ndraw_local, x_dim), jnp.float32)
                v = tbox_lo[None, :] + v * (tbox_hi - tbox_lo)[None, :]
                return jnp.dot(v, invT,
                               preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST) \
                    + ctr[None, :], ones

            def draw_points(_):
                # balls around random live points in whitened space, with
                # 1/multiplicity acceptance (cf. sample_from_points,
                # mlfriends.pyx:1072-1094)
                idx = jax.random.randint(kidx, (ndraw_local,), 0, nlive)
                centers = tpoints[idx]
                t_prop = centers + ball_offsets(jnp.sqrt(maxradiussq))
                d2 = pairwise_sqdist(tpoints, t_prop)
                within = jnp.logical_and(d2 <= maxradiussq, tmask[:, None])
                counts = jnp.sum(within, axis=0)
                mult_ok = jax.random.uniform(kmult, (ndraw_local,)) \
                    * jnp.maximum(counts, 1) < 1
                mult_ok = jnp.logical_and(mult_ok, counts >= 1)
                u = jnp.dot(t_prop, invT,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST) \
                    + ctr[None, :]
                return u, mult_ok

            branches = [draw_cube, draw_ellipsoid, draw_tbox]
            if kind == 'mlfriends':
                branches.append(draw_points)
            u, mult_ok = jax.lax.switch(method, branches, None)

            in_cube = jnp.logical_and(u > 0, u < 1).all(axis=1)
            member = jnp.logical_and(
                in_cube, _inside_ellipsoid(u, ell_ctr, ell_invcov, enlarge))
            member = jnp.logical_and(member, mult_ok)
            if kind == 'mlfriends':
                t = jnp.dot(u - ctr[None, :], T,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
                member = jnp.logical_and(
                    member, _radius_member(t, tpoints, tmask, maxradiussq))

            v = transform(u)
            if has_tregion:
                member = jnp.logical_and(
                    member,
                    _inside_ellipsoid(v, treg_ctr, treg_invcov, treg_enlarge))
            logl = jnp.where(member, loglike(v), -jnp.inf)
            if segment:
                # segment mode: billing stops at the acceptance budget,
                # and only rows that can possibly be consumed (above the
                # dispatch threshold, within budget) enter the consume
                # scan — compacted to a fixed window so the sequential
                # scan length is ~budget, not ~ndraw
                scan_cap = min(MAX_RETURN, ndraw_local)
                accepted0 = jnp.logical_and(member, logl > Lmin)
                budget = jnp.minimum(naccept_budget, scan_cap)
                wb = jnp.cumsum(accepted0.astype(jnp.int32)) <= budget
                member_b = jnp.logical_and(member, wb)
                valid = jnp.logical_and(accepted0, wb)
                order = jnp.argsort(jnp.logical_not(valid),
                                    stable=True)[:scan_cap]
                return u[order], logl[order], \
                    valid[order].astype(jnp.float32), jnp.sum(member_b)
            accepted = jnp.logical_and(member, logl > Lmin)
            # acceptance budget: processing stops at the budget-th
            # accepted row in draw order, exactly as a sequential sampler
            # that quits once it has enough would — later rows are
            # neither returned nor billed to ncall. Without this, an
            # early high-acceptance batch pays thousands of evaluations
            # for a handful of consumed points.
            budget = jnp.minimum(naccept_budget, kreturn)
            within_budget = jnp.cumsum(accepted.astype(jnp.int32)) <= budget
            member = jnp.logical_and(member, within_budget)
            accepted = jnp.logical_and(accepted, within_budget)
            nc = jnp.sum(member)
            # compact on device: accepted candidates first, preserving draw
            # order (stable sort), truncated to kreturn rows — keeps the
            # device->host transfer tiny regardless of ndraw
            order = jnp.argsort(jnp.logical_not(accepted), stable=True)
            sel = order[:min(kreturn, ndraw_local)]
            n_accepted = jnp.minimum(jnp.sum(accepted), len(sel))
            return u[sel], v[sel], logl[sel], n_accepted, nc

        return body

    def _make_pack(self):
        def pack(u, v, logl, n_acc, nc):
            # single f32 result array: each array in a fetched tuple costs
            # its own device->host round trip.
            # layout: k data rows [u | v | logl], then scalar rows holding
            # [nc, n_acc...] padded to the row width (f32-exact to 2**24).
            rows = jnp.concatenate(
                [u, v, logl[:, None].astype(jnp.float32)], axis=1)
            width = rows.shape[1]
            s = jnp.concatenate([
                jnp.ravel(nc).astype(jnp.float32),
                jnp.ravel(n_acc).astype(jnp.float32)])
            nsrows = -(-(s.shape[0]) // width)
            s = jnp.pad(s, (0, nsrows * width - s.shape[0]))
            return jnp.concatenate([rows, s.reshape(nsrows, width)], axis=0)

        return pack

    def _build(self, ndraw, kind, has_tregion, segment=True, num_params=0):
        """Segment-mode kernel: one dispatch draws AND consumes a batch."""
        assert segment
        body = self._make_body(ndraw, kind, has_tregion, segment=True)
        x_dim_ = self.x_dim
        layout, _ = self._geom_layout(has_tregion, num_params)
        from .segmentops import consume_scan, pack_segment

        @jax.jit
        def run_segment(key, live_u, live_L, geom):
            def g(name):
                off, shape = layout[name]
                n = int(np.prod(shape)) if len(shape) else 1
                return geom[off:off + n].reshape(shape)

            s = g('scalars')
            nlive = s[0].astype(jnp.int32)
            T, invT, ctr = g('T'), g('invT'), g('ctr')
            Lmin0 = jnp.min(live_L)          # padding is +inf
            tmask = jnp.arange(live_L.shape[0]) < nlive
            tpoints = jnp.dot(
                jnp.where(tmask[:, None], live_u, 0.0)
                - ctr[None, :], T,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            if has_tregion:
                treg_ctr, treg_invcov = g('treg_ctr'), g('treg_invcov')
                treg_enlarge = s[3]
            else:
                treg_ctr = jnp.zeros(x_dim_, jnp.float32)
                treg_invcov = jnp.eye(x_dim_, dtype=jnp.float32)
                treg_enlarge = jnp.float32(1.0)
            u, logl, valid, nc = body(
                key, tpoints, tmask, nlive, T, invT, ctr,
                s[1], g('ell_ctr'), g('ell_invcov'), s[2],
                g('ell_axes_T'), treg_ctr, treg_invcov,
                treg_enlarge, g('tbox_lo'), g('tbox_hi'), Lmin0,
                s[5].astype(jnp.int32), s[6].astype(jnp.int32))
            live_u2, live_L2, recs = consume_scan(
                live_u, live_L, u, logl, valid)
            packed = pack_segment(
                u, logl, recs, nc.astype(jnp.float32),
                jnp.mean(valid), jnp.float32(0.0))
            return live_u2, live_L2, packed

        return run_segment

    # --- segment mode -------------------------------------------------
    # Driven by integrator._explore_segments: the live set chains on the
    # device and each dispatch draws a candidate batch AND consumes it
    # (see segmentops.consume_scan). The whitened live points for the
    # MLFriends membership test are recomputed from the device live set
    # every dispatch — fresher than the classic path's host-shipped
    # copies.

    segment_capable = True
    # the p-space WrappingEllipsoid filter is fused into the proposal
    # body (has_tregion branch), so non-affine transforms keep segments
    segment_tregion_ok = True

    def segment_ok(self):
        """Whether segment mode should drive this sampler.

        Default ON for accelerator backends: auto-sized batches,
        chained device live state, packed single-array arguments and a
        depth-4 dispatch queue amortize the per-dispatch overhead that
        the classic budgeted path pays per refill (not yet measured on
        the GPU). Off on the cpu backend, where there is no dispatch
        latency to amortize and the per-node loop has lower constant
        factors. Override with
        ``sampler.fused_sampler.segment_enabled = True/False`` or
        ``ULTRANEST_TPU_SEGMENT_REJECTION=1/0``.
        """
        enabled = getattr(self, 'segment_enabled', None)
        if enabled is None:
            env = os.environ.get('ULTRANEST_TPU_SEGMENT_REJECTION')
            if env is not None:
                enabled = env == '1'
            else:
                enabled = jax.default_backend() != 'cpu'
        return enabled and self.nshards == 1

    def segment_start(self, us, Ls, ndraw=4096):
        """Upload live state and prepare the segment kernel cache."""
        from .ops.pairwise import pad_rows, round_up
        nlive, d = us.shape
        assert d == self.x_dim
        self._seg_nlive = nlive
        self._seg_npad = round_up(nlive)
        # batch size: the caller's request, raised to the engine's own
        # learned preference (see segment_fetch) — iterations per
        # dispatch is what amortizes the dispatch overhead, and billing
        # stops at the acceptance budget, so oversized batches cost
        # device flops only
        self._seg_ndraw_max = 1 << (14 if jax.default_backend() == 'cpu'
                                    else 17)
        pref = min(getattr(self, '_seg_ndraw_pref', 0), self._seg_ndraw_max)
        self._seg_ndraw = round_up(max(int(ndraw), 512, pref), 128)
        lu = pad_rows(np.asarray(us, np.float32), self._seg_npad)
        lL = pad_rows(np.asarray(Ls, np.float32), self._seg_npad,
                      fill=np.inf)
        self._seg_state = (jax.device_put(lu), jax.device_put(lL))
        self._seg_queue = []
        self._seg_method_i = 0
        self._seg_last_nc = None
        self._pending = []        # classic prefetch superseded

    def _get_segment_kernel(self, kind, has_tregion=False, num_params=0):
        ck = ('seg', self._seg_npad, self._seg_ndraw, kind, has_tregion,
              num_params)
        fn = self._propose_cache.get(ck)
        if fn is None:
            gkey = (_fn_fingerprint(self.loglike),
                    _fn_fingerprint(self.transform), self.x_dim,
                    self.nshards,
                    None if self.mesh is None else id(self.mesh), ck)
            fn = _kernel_cache_get(
                gkey, lambda: self._build(self._seg_ndraw, kind,
                                          has_tregion, segment=True,
                                          num_params=num_params))
            self._propose_cache[ck] = fn
        return fn

    def segment_launch(self, region, tregion=None):
        """Dispatch one chained draw+consume segment (non-blocking)."""
        layer = region.transformLayer
        x_dim = self.x_dim
        kind = 'mlfriends' if type(region).__name__ == 'MLFriends' \
            else 'ellipsoid'
        if hasattr(layer, 'T') and np.ndim(layer.T) == 2:
            T = _as_f32(layer.T)
            invT = _as_f32(layer.invT)
            ctr = _as_f32(layer.ctr)
        else:
            std = np.ravel(np.broadcast_to(layer.std, (1, x_dim)))
            mean = np.ravel(np.broadcast_to(layer.mean, (1, x_dim)))
            T = _as_f32(np.diag(1.0 / std))
            invT = _as_f32(np.diag(std))
            ctr = _as_f32(mean)
        maxr = region.maxradiussq if region.maxradiussq is not None else 0.0
        # ellipsoid-only regions report maxradiussq = inf / >f32max; clip so
        # the f32 geometry pack stays finite (f32max radius^2 accepts all)
        maxr = float(min(maxr, _F32MAX))
        sq = np.float32(maxr) ** 0.5
        tbox_lo = _as_f32(region.bbox_lo) - sq
        tbox_hi = _as_f32(region.bbox_hi) + sq
        method = METHOD_CYCLE[self._seg_method_i % len(METHOD_CYCLE)]
        if kind != 'mlfriends' and method == METHOD_POINTS:
            method = METHOD_ELLIPSOID
        has_tregion = tregion is not None
        if has_tregion:
            num_params = tregion.u.shape[1]
            treg_ctr, treg_invcov, treg_enlarge = tregion_geometry(
                tregion, num_params)
        else:
            num_params = 0
            treg_ctr = np.zeros(0, np.float32)
            treg_invcov = np.zeros(0, np.float32)
            treg_enlarge = np.float32(1.0)
        kernel = self._get_segment_kernel(kind, has_tregion, num_params)
        geom = np.concatenate([
            T.ravel(), invT.ravel(), ctr.ravel(),
            np.asarray(region.ellipsoid_center, np.float32).ravel(),
            np.asarray(region.ellipsoid_invcov, np.float32).ravel(),
            np.asarray(region.ellipsoid_axes_T, np.float32).ravel(),
            tbox_lo.ravel(), tbox_hi.ravel(),
            treg_ctr.ravel(), treg_invcov.ravel(),
            np.asarray([self._seg_nlive, maxr, region.enlarge,
                        treg_enlarge, 0.0,
                        method, max(64, self._seg_nlive // 2)],
                       np.float32),
        ])
        lu, lL, packed = kernel(
            self._next_key(), self._seg_state[0], self._seg_state[1], geom)
        self._seg_state = (lu, lL)
        try:
            packed.copy_to_host_async()
        except Exception:
            pass
        self._seg_queue.append(packed)

    def segment_fetch(self):
        """Block on the oldest queued segment; returns parsed records."""
        from .parallel.launch import fetch_replicated
        packed = fetch_replicated(self._seg_queue.pop(0)).astype(float)
        d = self.x_dim
        rows, scal = packed[:-1], packed[-1]
        # guard against f32 rounding onto the cube boundary (parity with
        # the classic _unpack clip)
        np.clip(rows[:, :d], 1e-7, 1 - 1e-7, out=rows[:, :d])
        flags = rows[:, d + 5]
        nc = int(scal[0])
        if nc < max(1, self._seg_ndraw // 200):
            # proposal strategy starved: rotate to the next method
            self._seg_method_i += 1
        # grow the batch when a dispatch cannot fill the acceptance
        # budget: every extra dispatch pays a full dispatch + fetch
        # round trip, while extra draws are budget-capped in billing
        # and nearly free in device flops
        scan_cap = min(MAX_RETURN, max(128, self._seg_ndraw))
        navail = float(scal[1]) * scan_cap
        budget = max(64, self._seg_nlive // 2)
        if navail < 0.9 * budget and self._seg_ndraw < self._seg_ndraw_max:
            factor = min(4.0, 1.5 * budget / max(navail, 8.0))
            want = int(self._seg_ndraw * max(factor, 2.0))
            self._seg_ndraw_pref = min(want, self._seg_ndraw_max)
            from .ops.pairwise import round_up
            self._seg_ndraw = round_up(self._seg_ndraw_pref, 128)
        return dict(
            u=rows[:, :d], L=rows[:, d],
            accept=rows[:, d + 1] > 0.5,
            worst=rows[:, d + 2].astype(np.int64),
            Lmin=rows[:, d + 3],
            rank=rows[:, d + 4].astype(np.int64),
            plateau=flags >= 2, dup=(flags % 2) >= 1,
            nc=nc, done_frac=float(scal[1]), width=float(scal[2]))

    def segment_pending(self):
        """Number of dispatches in flight."""
        q = getattr(self, '_seg_queue', None)
        return len(q) if q else 0

    def segment_stop(self):
        """Leave segment mode, dropping device state and queued work."""
        self._seg_state = None
        self._seg_queue = None

    def __call__(self, region, Lmin, ndraw, tregion=None, method=None,
                 naccept_budget=None):
        """Propose *ndraw* candidates; returns (u, v, logl, nc) compacted.

        *region* is an MLFriends-family region (host object); its geometry
        is shipped as arrays with the call. *method* picks the proposal
        strategy (default: wrapping ellipsoid).

        If prefetched dispatches are in flight (see :meth:`prefetch`),
        the oldest is harvested instead of paying a fresh synchronous
        dispatch.
        """
        if self._pending:
            out, num_params, ndrawn = self._pending.pop(0)
            return self._unpack(out, num_params, ndrawn)
        out, num_params, ndrawn = self._launch(region, Lmin, ndraw,
                                               tregion, method,
                                               naccept_budget)
        return self._unpack(out, num_params, ndrawn)

    def prefetch(self, region, Lmin, ndraw, tregion=None, method=None,
                 naccept_budget=None):
        """Launch upcoming proposal batches asynchronously.

        The device computes (and streams results to the host) while the
        caller keeps consuming its current candidate buffer; subsequent
        ``__call__`` harvests them oldest-first. Up to
        ``prefetch_depth`` dispatches are kept in flight — candidates in
        deeper batches were proposed at a slightly stale threshold,
        which only costs extra rejected rows (the consumer re-filters by
        the live ``Lmin``), while hiding the full dispatch+transfer
        round trip. No-op on the cpu backend: there is no second
        processor to overlap with.
        """
        while len(self._pending) < self.prefetch_depth:
            self._pending.append(self._launch(region, Lmin, ndraw,
                                              tregion, method,
                                              naccept_budget))

    def _unpack(self, out, num_params, ndraw):
        x_dim = self.x_dim
        # ONE device->host transfer for the whole packed result: each
        # fetched array pays its own round trip
        from .parallel.launch import fetch_replicated
        packed = fetch_replicated(out).astype(float)
        width = x_dim + num_params + 1
        nscalars = 1 + (self.nshards if self.nshards > 1 else 1)
        nsrows = -(-nscalars // width)
        rows, flat = packed[:-nsrows], packed[-nsrows:].ravel()
        u = rows[:, :x_dim]
        v = rows[:, x_dim:x_dim + num_params]
        logl = rows[:, -1]
        nc = int(flat[0])
        n_accepted = flat[1:1 + (self.nshards if self.nshards > 1 else 1)]

        if self.nshards > 1:
            # per-shard blocks of kreturn rows; keep each shard's accepted
            kreturn = len(u) // self.nshards
            keep = np.zeros(len(u), dtype=bool)
            for s in range(self.nshards):
                keep[s * kreturn:s * kreturn + int(n_accepted[s])] = True
            u, v, logl = u[keep], v[keep], logl[keep]
        else:
            k = min(int(n_accepted[0]), len(u))
            u, v, logl = u[:k], v[:k], logl[:k]
        # guard against f32 rounding to the cube boundary
        np.clip(u, 1e-7, 1 - 1e-7, out=u)
        return u, v, logl, int(nc), ndraw

    def _launch(self, region, Lmin, ndraw, tregion=None, method=None,
                naccept_budget=None):
        ndraw = round_up(ndraw, 128)
        layer = region.transformLayer
        x_dim = self.x_dim
        kind = 'mlfriends' if type(region).__name__ == 'MLFriends' else 'ellipsoid'
        has_tregion = tregion is not None

        # express the layer as an affine map (ScalingLayer is diagonal)
        if hasattr(layer, 'T') and np.ndim(layer.T) == 2:
            T = _as_f32(layer.T)
            invT = _as_f32(layer.invT)
            ctr = _as_f32(layer.ctr)
        else:
            std = np.ravel(np.broadcast_to(layer.std, (1, x_dim)))
            mean = np.ravel(np.broadcast_to(layer.mean, (1, x_dim)))
            T = _as_f32(np.diag(1.0 / std))
            invT = _as_f32(np.diag(std))
            ctr = _as_f32(mean)

        npts = len(region.unormed)
        npad = round_up(npts)
        tpoints = pad_rows(np.asarray(region.unormed, np.float32), npad)

        if has_tregion:
            num_params = tregion.u.shape[1]
            treg_ctr, treg_invcov, treg_enlarge = tregion_geometry(
                tregion, num_params)
        else:
            num_params = x_dim
            treg_ctr = np.zeros(0, np.float32)
            treg_invcov = np.zeros(0, np.float32)
            treg_enlarge = np.float32(1.0)

        maxr = region.maxradiussq if region.maxradiussq is not None else 0.0
        # clip: ellipsoid-only regions report maxradiussq >f32max (see above)
        maxr = float(min(maxr, _F32MAX))
        tbox_lo = _as_f32(region.bbox_lo) - np.float32(maxr) ** 0.5
        tbox_hi = _as_f32(region.bbox_hi) + np.float32(maxr) ** 0.5

        if naccept_budget is None:
            # half the live-point count: ample to keep the consumer fed
            # past the next refill, small enough that a high-acceptance
            # batch cannot burn evaluations on points that will be stale
            # before they are reached
            naccept_budget = max(64, npts // 2)
        if method is None:
            method = METHOD_ELLIPSOID
        if kind != 'mlfriends' and method == METHOD_POINTS:
            method = METHOD_ELLIPSOID

        # ship all geometry as ONE f32 vector (see _geom_layout)
        geom = np.concatenate([
            np.asarray(T, np.float32).ravel(),
            np.asarray(invT, np.float32).ravel(),
            np.asarray(ctr, np.float32).ravel(),
            np.asarray(region.ellipsoid_center, np.float32).ravel(),
            np.asarray(region.ellipsoid_invcov, np.float32).ravel(),
            np.asarray(region.ellipsoid_axes_T, np.float32).ravel(),
            tbox_lo.ravel(), tbox_hi.ravel(),
            treg_ctr.ravel(), treg_invcov.ravel(),
            np.asarray([npts, maxr, region.enlarge, treg_enlarge,
                        Lmin, method, naccept_budget], np.float32),
        ])

        propose = self._get_propose(ndraw, kind, has_tregion, num_params)
        sub = self._next_key(self.nshards if self.nshards > 1 else None)
        if self.nshards > 1:
            from .parallel.launch import is_multiprocess_mesh, put_args
            if is_multiprocess_mesh(self.mesh):
                # multi-controller job: build global arrays from the
                # identical host copies every process holds
                from jax.sharding import PartitionSpec as P
                sub, tpoints, geom = put_args(
                    self.mesh, (P(self.axis_name), P(), P()),
                    (sub, tpoints, geom))
        out = propose(sub, tpoints, geom)
        try:
            out.copy_to_host_async()
        except Exception:
            pass
        return out, num_params, ndraw
