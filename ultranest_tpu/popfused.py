# noqa: D400 D205
"""
Device-resident population slice sampler
----------------------------------------

The fully device-resident step sampler: a whole walker population advances
through all its slice-sampling steps inside a single device dispatch —
``lax.scan`` over steps, ``lax.while_loop`` over the shrink iterations,
with the batched likelihood called once per shrink round. One dispatch
yields ``popsize`` independent samples.

This is the engine the reference's `popstepsampler.py` points towards
("likelihoods based on GPUs ... can evaluate hundreds of points as
efficiently as one"), taken to its conclusion: zero host round-trips
inside the walk. Per-walker slices shrink independently (no worker
reassignment), which keeps detailed balance exactly.

Use when the likelihood/transform are jax-traceable::

    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=256, nsteps=2 * ndim, jax_loglike=..., jax_transform=...)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ops.pairwise import pad_rows, round_up
from .popstepsampler import (GenericPopulationSampler,
                             decorrelation_gm_target,
                             diagnose_move_distances,
                             reference_sqdistance_info)

__all__ = ['FusedPopulationSliceSampler', 'FusedPopulationRandomWalkSampler',
           'optimal_spec_depth', 'ROUND_OVERHEAD_S']


_PROBE_CACHE = {}


# Fixed cost of one shrink round of the spec walk (the while-loop body
# without its likelihood rows), the ``A`` of :func:`optimal_spec_depth`.
# Measured with ``evaluate/measure_spec_round.py`` on one NVIDIA H100
# 80GB HBM3 (700 W limit), popsize 4096, d = 50, near-free likelihood:
# 35.2 us per round at depth 1 and 55.8 us at depth 8, so A = 32 us and
# 2.9 us per extra popsize-row batch.
ROUND_OVERHEAD_S = 32e-6


def optimal_spec_depth(t_row_s, dmax, round_overhead_s=None,
                       p_accept=0.35, min_win=0.8):
    """Speculation depth minimizing device time per accepted slice step.

    Model: one shrink round of the spec engine costs
    ``A + D * t_row`` (fixed while-loop-body overhead
    ``round_overhead_s``, default :data:`ROUND_OVERHEAD_S`, plus D
    popsize-row likelihood batches) and
    completes a walker's current step with probability
    ``1 - (1 - p)**D`` (first hit within the D speculative shrink
    candidates). Minimizing expected cost per completed step::

        cost(D) = (A + D * t_row) / (1 - (1 - p)**D)

    For cheap likelihoods ``t_row -> 0`` the fixed overhead dominates
    and cost(D) is decreasing: keep the configured depth. For expensive
    likelihoods ``t_row >> A`` speculation multiplies billed rows for a
    bounded completion gain and D=1 wins. The acceptance prior
    ``p_accept`` is a representative slice-shrink hit rate; the
    decision is insensitive to it in the two regimes that matter.

    A smaller depth is returned only when its modeled cost beats the
    configured depth by at least ``1/min_win`` (default: 20% win) — the
    model is too coarse to flip near-ties, and near-ties should keep
    the user's configuration.
    """
    if round_overhead_s is None:
        round_overhead_s = ROUND_OVERHEAD_S
    q = 1.0 - p_accept
    cost = {d: (round_overhead_s + d * t_row_s) / (1.0 - q ** d)
            for d in range(1, int(dmax) + 1)}
    best = min(cost, key=cost.get)
    if best < dmax and cost[best] < min_win * cost[dmax]:
        return best
    return int(dmax)


def _cube_intersection(u, v):
    """Line coordinates where rays u + t*v cross the unit cube faces."""
    with np.errstate(divide='ignore'):
        a = jnp.where(v != 0, (0.0 - u) / v, -jnp.inf)
        b = jnp.where(v != 0, (1.0 - u) / v, jnp.inf)
    lo = jnp.minimum(a, b)
    hi = jnp.maximum(a, b)
    return jnp.max(lo, axis=1), jnp.min(hi, axis=1)


class FusedPopulationSliceSampler(GenericPopulationSampler):
    """Vectorized slice sampler running entirely on device.

    Per step, each walker draws a direction (50/50 mix of
    differential-evolution pairs and region principal axes), intersects it
    with the unit cube, and shrink-samples its slice until it finds a
    point above the threshold (or ``max_it`` is reached, in which case it
    stays). All walkers and all steps run inside one jit dispatch.

    Parameters
    ----------
    popsize: int
        number of walkers (= samples harvested per dispatch)
    nsteps: int
        steps per walker until a point counts as independent
    jax_loglike: jax function
        batched log-likelihood (n, params) -> (n,)
    jax_transform: jax function or None
        batched prior transform
    scale: float
        slice length factor (1.0 with cube clipping is rigorous)
    max_it: int
        maximum shrink iterations per step
    scale_adapt_factor: float
        scale adaptation (1 disables); adapts towards
        final-interval ~ scale / adapt_slice_scale_target
    adapt_slice_scale_target: float
        targeted final interval ratio
    seed: int
        device RNG seed
    engine: str
        'spec' (default): speculative shrink — each round evaluates a
        depth-``spec_depth`` precomputed shrink chain per walker in one
        batched call, advancing every active walker by up to one full
        slice step per sequential round (fewest latency-bound rounds);
        'async': walkers advance at independent step indices, one
        likelihood row per walker per shrink round (fewest evaluations);
        'sync': all walkers lockstep per step (reference engine).
    spec_depth: int
        candidates per walker per round for the 'spec' engine. Deeper
        chains trade discarded speculative evaluations (the likelihood
        IS called on rows past each walker's first acceptance, and they
        are billed) for fewer latency-bound device rounds; the accepted
        chain is exactly the sequential sampler's chain at any depth.
        Default 8 (not measured on the H100: a depth sweep is an open
        benchmark item); lower it when the likelihood is expensive
        enough that evaluations, not dispatch rounds, dominate
        (``spec_depth_auto`` does so from a cost probe).
    harvest_frac: float
        async engine: end the dispatch when this fraction of walkers
        completed their chains (the rest are discarded). WARNING: values
        below 1.0 select walkers by completion speed, which correlates
        with their rejection history and measurably biases logZ (3σ high
        on a 20-d asymgauss at 0.75) — leave at 1.0 unless you know what
        you are doing.
    adaptive_nsteps: bool
        govern the chain length online (device-engine analogue of the
        reference's jump-distance criterion, stepsampler.py:381-448,
        889-923): after each dispatch, the fraction of chains whose
        whitened start→end distance exceeds the region decorrelation
        scale (:func:`popstepsampler.diagnose_move_distances`) is
        measured over the whole population; below 50% the chains are
        too short for independent samples and ``nsteps`` DOUBLES (each
        change costs one kernel re-jit, so adaptation is log-scale by
        design); above 90% — comfortably decorrelated — nsteps decays
        gently, never below the initial value and never after a
        doubling (re-compile hysteresis). Without this, a too-small
        fixed nsteps silently biases logZ (measured +17 on a 100-d
        gaussian at nsteps=100 vs the tuned 400).
    max_nsteps: int
        adaptation ceiling (reference default: 1000)
    """

    def __init__(self, popsize, nsteps, jax_loglike, jax_transform=None,
                 scale=1.0, max_it=64, scale_adapt_factor=1.0,
                 adapt_slice_scale_target=2.0, seed=0, logfile=None,
                 engine='spec', harvest_frac=1.0, spec_depth=8, mesh=None,
                 axis_name=None, adaptive_nsteps=False, max_nsteps=1000,
                 spec_depth_auto=None):
        self.popsize = popsize
        self.nsteps = nsteps
        self.nsteps_min = nsteps
        self.adaptive_nsteps = adaptive_nsteps
        self.max_nsteps = max_nsteps
        self._nsteps_grew = False
        self._gm_low_streak = 0
        self._gm_grace = 0
        # second growth signal: MWW insertion-rank uniformity, fed by
        # the integrator (observe_insertion_ranks). A popsize-scaled
        # window gives ~one decision per dispatch at high power.
        from .ordertest import UniformOrderAccumulator
        self._mww_acc = UniformOrderAccumulator()
        self._mww_window = max(1024, popsize)
        self._mww_zthreshold = 4.0
        self.engine = engine
        self.harvest_frac = harvest_frac
        self.spec_depth = spec_depth
        # None: probe-and-lower on accelerator backends only (CPU runs
        # keep the configured depth so tests stay deterministic).
        # True/False force the probe on/off.
        self.spec_depth_auto = spec_depth_auto
        self._depth_resolved = False
        self._pending = None
        self._last_yield = 0
        self._buf = None
        self._buf_i = 0
        self._buf_sufmax = None
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
        self.nshards = int(mesh.devices.size) if mesh is not None else 1
        if self.nshards > 1:
            assert popsize % self.nshards == 0, (
                'popsize must divide evenly over the %d mesh devices'
                % self.nshards)
        self.jax_loglike = jax_loglike
        self.jax_transform = jax_transform if jax_transform is not None \
            else (lambda u: u)
        self.scale = float(scale)
        self.max_it = max_it
        self.scale_adapt_factor = scale_adapt_factor
        self.adapt_slice_scale_target = adapt_slice_scale_target
        self.key = jax.random.PRNGKey(seed)
        # per-dispatch keys from a host RNG: a device-side split per
        # launch would cost a dispatch + fetch round trip
        self._key_rng = np.random.Generator(np.random.PCG64(seed))
        self.logfile = logfile
        self.ncalls = 0
        # evaluations a strictly sequential sampler would have needed
        # for the same accepted chains (== ncalls minus speculative
        # waste; see _build_spec's useful-work accounting)
        self.ncalls_useful = 0
        self.nrejects = 0
        self.discarded = 0
        self.logstat = []
        self.logstat_labels = ['accept_rate', 'efficiency', 'scale',
                               'nsteps', 'far_enough', 'mean_rel_jump']
        self._kernel_cache = {}
        # in-flight speculative compiles of the doubled-nsteps segment
        # kernel, keyed like _seg_get_kernel: {ck: threading.Thread}
        self._seg_prewarm = {}
        # (has_tregion, num_params): whether kernels fuse the p-space
        # wrapping-ellipsoid filter for non-affine transforms
        self._treg_key = (False, 0)

    def _next_key(self):
        return self._key_rng.integers(0, 2**32, size=2, dtype=np.uint32)

    def _global_ck(self, ck):
        """Process-level cache key: same-model samplers share kernels.

        Samplers are recreated per run (benchmarks, calibrator
        doubling); without this every instance re-traces + re-lowers
        identical programs.
        """
        from .fused import _fn_fingerprint
        return ('popfused', _fn_fingerprint(self.jax_loglike),
                _fn_fingerprint(self.jax_transform), self.engine,
                self.popsize, self.nsteps, self.max_it, self.spec_depth,
                self.harvest_frac, self.nshards, self._treg_key,
                None if self.mesh is None else id(self.mesh), ck)

    def __str__(self):
        """Return string representation."""
        return 'FusedPopulationSliceSampler(popsize=%d, nsteps=%d, scale=%g)' \
            % (self.popsize, self.nsteps, self.scale)

    def region_changed(self, Ls, region):
        """React to a region rebuild (no-op; state is per-refill)."""
        pass

    def _buf_remaining(self):
        return 0 if self._buf is None else len(self._buf[2]) - self._buf_i

    def needs_live_points(self, Lmin):
        """Whether the next ``__next__`` call may dispatch a population.

        The integrator skips gathering the live-point coordinate arrays
        on iterations that can be served from the buffer. Serving is
        guaranteed when some remaining buffered point exceeds *Lmin*
        (tracked as a suffix maximum), no prefetch is due, and a
        dispatch is already in flight or not needed.
        """
        n = self._buf_remaining()
        if n == 0:
            return True
        if self._pending is None and \
                n <= max(1, int(0.3 * self._last_yield)):
            return True
        return not (self._buf_sufmax[self._buf_i] > Lmin)

    def _treg_eval(self):
        """Batch evaluator fusing the p-space wrapping-ellipsoid filter.

        Returns ``ev(u_rows, treg) -> (L, billed)``: transforms, tests
        membership in the (packed) WrappingEllipsoid when one is
        configured, and evaluates the likelihood. Rows outside the
        ellipsoid get L = -inf (a rejection, shrinking slices exactly
        like a below-threshold point) and are NOT billed — the
        reference filters them before calling the likelihood
        (integrator.py:2135-2157, stepsampler.py:1067-1069).
        """
        loglike = self.jax_loglike
        transform = self.jax_transform
        has_tregion, p = self._treg_key
        if not has_tregion:
            def ev(u_rows, treg):
                return (loglike(transform(u_rows)),
                        jnp.ones(u_rows.shape[0], bool))
            return ev

        def ev(u_rows, treg):
            from .fused import _inside_ellipsoid
            v = transform(u_rows)
            tin = _inside_ellipsoid(
                v, treg[:p], treg[p:p + p * p].reshape(p, p), treg[-1])
            return jnp.where(tin, loglike(v), -jnp.inf), tin
        return ev

    def _pack_whiten(self, region):
        """(d+1, d) f32 pack: whitening matrix + wrapped-dim mask row.

        Feeds :func:`segmentops.whitened_jump2` so the segment kernels
        compute each chain's whitened travel distance on device — one
        record column home instead of the d start coordinates. T is ``transformLayer.T`` where the layer is
        affine, else ``diag(1/std)`` (ScalingLayer); saturating f32
        cast as for the other packed geometry.
        """
        layer = region.transformLayer
        d = self._seg_ndim
        T = getattr(layer, 'T', None)
        if T is None or np.ndim(T) != 2:
            std = np.asarray(
                getattr(layer, 'std', 1.0), np.float64).reshape(-1)
            if std.size != d:
                std = np.full(d, std[0] if std.size else 1.0)
            T = np.diag(1.0 / np.maximum(std, 1e-300))
        from .fused import _as_f32
        wmask = np.zeros((1, d), np.float32)
        wdims = getattr(layer, 'wrapped_dims', None)
        if wdims is not None and len(wdims):
            wmask[0, np.asarray(wdims, dtype=int)] = 1.0
        return np.vstack([_as_f32(T), wmask])

    def _pack_tregion(self, tregion):
        """Flat f32 vector [ctr(p), invcov(p,p), enlarge] (or a dummy)."""
        if tregion is None:
            return np.zeros(1, np.float32)
        from .fused import tregion_geometry
        p = tregion.u.shape[1]
        ctr, invcov, enlarge = tregion_geometry(tregion, p)
        return np.concatenate([
            ctr.ravel(), invcov.ravel(),
            np.asarray([enlarge], np.float32)]).astype(np.float32)

    def _sync_treg_key(self, tregion):
        """Track the (has_tregion, p) kernel variant; returns True if
        it changed (cached kernels for the other variant still live)."""
        tk = (tregion is not None,
              tregion.u.shape[1] if tregion is not None else 0)
        if tk != self._treg_key:
            self._treg_key = tk
            return True
        return False

    def _probe_likelihood_cost(self, x_dim, reps=256):
        """Warm per-(popsize-row-batch) cost of the user's likelihood.

        One jitted dispatch runs ``reps`` sequential evaluations so the
        per-batch cost is amplified well above the dispatch latency;
        the latency itself is measured with a null dispatch and
        subtracted. Returns seconds
        per (popsize, x_dim) batch.
        """
        import time as _time
        P = self.popsize
        ll, tr = self.jax_loglike, self.jax_transform

        def loop_fn(u, n):
            def body(i, acc):
                # the +i*eps nudge defeats loop-invariant hoisting
                return acc + jnp.sum(ll(tr(u + i * jnp.float32(1e-9))))
            return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

        u = jnp.full((P, x_dim), 0.5, jnp.float32)

        def timed(fn, *a):
            fn(*a).block_until_ready()          # compile + warm
            t0 = _time.perf_counter()
            fn(*a).block_until_ready()
            t1 = _time.perf_counter()
            fn(*a).block_until_ready()
            return min(t1 - t0, _time.perf_counter() - t1)

        null = jax.jit(lambda x: x + 1.0)
        t_null = timed(null, jnp.float32(0.0))
        # stage 1: a cheap 8-rep loop decides whether the expensive
        # 256-rep amplification is needed (skips a long probe when the
        # likelihood is already obviously slow)
        loop8 = jax.jit(lambda x: loop_fn(x, 8))
        t8 = timed(loop8, u)
        if t8 - t_null > 0.05:
            return max(0.0, (t8 - t_null)) / 8
        loopn = jax.jit(lambda x: loop_fn(x, reps))
        tn = timed(loopn, u)
        return max(0.0, (tn - t_null)) / reps

    def _resolve_spec_depth(self, x_dim):
        """One-time auto-tune of ``spec_depth`` before any kernel build.

        Probes the likelihood's per-batch device cost and lowers the
        speculation depth when the billed extra rows cost more than the
        shrink rounds they save (:func:`optimal_spec_depth`) — so
        expensive likelihoods do not silently pay depth-8 billing for a
        latency optimization they cannot benefit from. Runs on
        accelerator backends by default;
        ``spec_depth_auto`` forces it on/off.
        """
        if self._depth_resolved:
            return
        self._depth_resolved = True
        auto = self.spec_depth_auto
        if auto is None:
            auto = jax.default_backend() not in ('cpu',)
        if not auto or self.engine != 'spec' or self.spec_depth <= 1:
            return
        try:
            # process-level memo: benchmarks and the calibrator recreate
            # samplers for the same model; the probe is 3 dispatches +
            # an amplified likelihood loop, and its answer only depends
            # on (model, P, x_dim)
            from .fused import _fn_fingerprint
            memo = (_fn_fingerprint(self.jax_loglike),
                    _fn_fingerprint(self.jax_transform),
                    self.popsize, x_dim)
            t_row = _PROBE_CACHE.get(memo)
            if t_row is None:
                t_row = self._probe_likelihood_cost(x_dim)
                _PROBE_CACHE[memo] = t_row
        except Exception:
            return          # unprobeable likelihood: keep configuration
        d = optimal_spec_depth(t_row, self.spec_depth)
        if d < self.spec_depth:
            import logging
            logging.getLogger('ultranest_tpu.popfused').info(
                'spec_depth auto-tuned %d -> %d (likelihood batch cost '
                '%.3f ms)', self.spec_depth, d, 1e3 * t_row)
            if self.logfile:
                self.logfile.write('spec-depth\t%d\t%d\t%g\n'
                                   % (self.spec_depth, d, t_row))
            self.spec_depth = d

    def _get_kernel(self, npad, x_dim):
        ck = (npad, x_dim, self.nsteps, self._treg_key)
        fn = self._kernel_cache.get(ck)
        if fn is None:
            from .fused import _kernel_cache_get

            def build_fn():
                build = {'spec': self._build_spec,
                         'async': self._build_async,
                         'sync': self._build,
                         'rwalk': getattr(self, '_build_rwalk', None),
                         }[self.engine]
                if self.nshards == 1:
                    return build(npad, x_dim)
                return self._build_sharded(build, npad, x_dim)

            fn = _kernel_cache_get(self._global_ck(ck), build_fn)
            self._kernel_cache[ck] = fn
        return fn

    def _build_sharded(self, build, npad, x_dim):
        """shard_map the population over a device mesh.

        Walkers split evenly across shards; every shard holds the full
        (replicated) live-point set and runs its own independent loop —
        no collectives inside, so per-shard trip counts may diverge —
        followed by one tiled ``all_gather`` of the packed results. This
        is the mesh equivalent of the reference's MPI data parallelism
        (each rank proposes/evaluates its own batch, integrator.py:
        1916-1928), with `fold_in`-derived per-shard RNG replacing
        rank-hashed seeds (integrator.py:1239-1251).
        """
        from jax.sharding import PartitionSpec as PS
        local = build(npad, x_dim, self.popsize // self.nshards)
        axis_name = self.axis_name

        def shard_fn(key, live_u, live_L, nlive, axes, Lmin, scale, treg):
            k = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            packed = local(k, live_u, live_L, nlive, axes, Lmin, scale,
                           treg)
            return jax.lax.all_gather(packed, axis_name, tiled=True)

        mapped = jax.shard_map(shard_fn, mesh=self.mesh,
                               in_specs=(PS(),) * 8, out_specs=PS(),
                               check_vma=False)
        return jax.jit(mapped)

    def _build_spec(self, npad, x_dim, popsize=None, segment=False,
                    walk_only=False, depth=None):
        """Speculative-shrink engine (the default device engine).

        A slice-shrink *rejection* updates the bracket deterministically
        — no likelihood value needed — so the next ``spec_depth``
        candidate positions of every walker's shrink chain can be
        precomputed and evaluated in ONE batched likelihood call. The
        first candidate above the threshold wins; later candidates are
        discarded (their draws were conditioned on rejection, so the
        accepted chain is *exactly* the sequential sampler's chain).
        Each sequential device round therefore advances every active
        walker by up to one full slice step instead of one shrink
        iteration: ~10x fewer latency-bound ``while_loop`` rounds than
        the lockstep engine, with (popsize x spec_depth)-row likelihood
        batches that a cheap likelihood adds little to each round.

        Walkers hold independent (step, direction, bracket) state as in
        the async engine (cf. the per-walker generation counters of the
        reference's stepfuncs.pyx::evolve); completed walkers freeze.
        """
        ev = self._treg_eval()
        P = popsize or self.popsize
        # depth=1 degenerates to the async engine's round semantics
        # (one candidate per walker per round, shrink on rejection) —
        # this is how the async engine gets its segment fast path
        D = self.spec_depth if depth is None else depth
        nsteps = self.nsteps
        # rounds cap: the while_loop exits as soon as the population is
        # done, so the cap only bites pathologically slow walks — and it
        # must be generous, because walkers still unfinished at the cap
        # are discarded, which both wastes their whole chains and
        # selects survivors by shrink speed (a logZ bias risk). A tight
        # cap (2*nsteps + max_it/D) made the thin-shell benchmark burn
        # 43x more evaluations than necessary.
        max_rounds = nsteps * max(4, (self.max_it + D - 1) // D)
        target_done = max(1, int(np.ceil(self.harvest_frac * P)))

        def spec_walk(key, live_u, live_L, nlive, axes, Lmin, scale, treg):
            kstart, kdir, kt = jax.random.split(key, 3)

            # All randomness pre-generated in bulk OUTSIDE the loop
            # (in-loop threefry calls serialize into latency-bound
            # chains on device):
            #  - xibank[r, :, :]: the D speculative slice draws of
            #    every walker in round r
            #  - dirbank[s, :]: walker directions for their step s
            xibank = jax.random.uniform(kt, (max_rounds, P, D))
            kde1, kde2, kax, kchoice = jax.random.split(kdir, 4)
            i1 = jax.random.randint(kde1, (nsteps, P), 0, nlive)
            i2 = jax.random.randint(kde2, (nsteps, P), 0, nlive - 1)
            i2 = jnp.where(i2 >= i1, i2 + 1, i2)
            v_de = live_u[i1] - live_u[i2]
            jx = jax.random.randint(kax, (nsteps, P), 0, x_dim)
            v_ax = axes[jx]
            pick = jax.random.uniform(kchoice, (nsteps, P)) < 0.5
            dirbank = jnp.where(pick[..., None], v_de, v_ax) * scale

            idx0 = jax.random.randint(kstart, (P,), 0, nlive)
            u0 = live_u[idx0]
            L0 = live_L[idx0]
            v0 = dirbank[0]
            tl0, tr0 = _cube_intersection(u0, v0)

            def cond(state):
                (u, L, v, tl, tr, step, done, widths, nw, it, ncr,
                 nur) = state
                return jnp.logical_and(it < max_rounds,
                                       jnp.sum(done) < target_done)

            def body(state):
                (u, L, v, tl, tr, step, done, widths, nw, it, ncr,
                 nur) = state
                # speculative shrink chain: D candidates per walker,
                # each drawn as if all earlier ones were rejected
                xi = xibank[it]
                tlc, trc = tl, tr
                ts = []
                for j in range(D):
                    t = tlc + xi[:, j] * (trc - tlc)
                    ts.append(t)
                    tlc = jnp.where(t < 0, t, tlc)
                    trc = jnp.where(t >= 0, t, trc)
                ts = jnp.stack(ts, axis=1)                      # (P, D)

                up = u[:, None, :] + ts[..., None] * v[:, None, :]
                Lp, tin = ev(up.reshape(P * D, x_dim), treg)
                Lp = Lp.reshape(P, D)
                # billing counts the walkers still working this round
                # (done walkers' lanes are computed but semantically
                # dead, exactly like masked non-members on the
                # rejection path) - the reference's engine evaluates
                # only active walkers, and never calls the likelihood
                # on tregion-filtered rows
                ncr = ncr + jnp.sum(jnp.logical_and(
                    tin.reshape(P, D), (~done)[:, None]))

                hit = Lp > Lmin                                 # (P, D)
                anyhit = jnp.logical_and(jnp.any(hit, axis=1), ~done)
                # first hit in chain order, selected arithmetically
                # (a masked sum instead of a per-row gather)
                jstar = jnp.argmax(hit, axis=1)
                # useful-work accounting: the sequential sampler would
                # have evaluated candidates 0..jstar (jstar accepted,
                # earlier ones rejected) — or all D on a no-hit round.
                # Everything past the first hit was speculation
                # conditioned on a rejection that did not happen.
                kneed = jnp.where(jnp.any(hit, axis=1), jstar + 1, D)
                nur = nur + jnp.sum(jnp.logical_and(
                    jnp.logical_and(
                        jnp.arange(D)[None, :] < kneed[:, None],
                        tin.reshape(P, D)),
                    (~done)[:, None]))
                sel = jnp.arange(D)[None, :] == jstar[:, None]
                tstar = jnp.sum(jnp.where(sel, ts, 0.0), axis=1)
                Lstar = jnp.sum(jnp.where(sel, Lp, 0.0), axis=1)
                u = jnp.where(anyhit[:, None], u + tstar[:, None] * v, u)
                L = jnp.where(anyhit, Lstar, L)
                step = step + anyhit
                newly_done = jnp.logical_and(anyhit, step >= nsteps)
                widths = widths + jnp.sum(jnp.where(anyhit, tr - tl, 0.0))
                nw = nw + jnp.sum(anyhit)
                done = jnp.logical_or(done, newly_done)

                # no acceptance: keep the fully shrunk bracket
                rej = jnp.logical_and(~anyhit, ~done)
                tl = jnp.where(rej, tlc, tl)
                tr = jnp.where(rej, trc, tr)

                # accepted (and not done): pre-drawn next direction and
                # a fresh full chord
                renew = jnp.logical_and(anyhit, ~done)
                s = jnp.clip(step, 0, nsteps - 1)
                vn = jnp.take_along_axis(
                    dirbank, s[None, :, None], axis=0)[0]
                v = jnp.where(renew[:, None], vn, v)
                tln, trn = _cube_intersection(u, v)
                tl = jnp.where(renew, tln, tl)
                tr = jnp.where(renew, trn, tr)
                return (u, L, v, tl, tr, step, done, widths, nw, it + 1,
                        ncr, nur)

            init = (u0, L0, v0, tl0, tr0, jnp.zeros(P, jnp.int32),
                    jnp.zeros(P, bool), jnp.float32(0.0),
                    jnp.int32(0), jnp.int32(0), jnp.int32(0),
                    jnp.int32(0))
            (uf, Lf, _, tl, tr, step, done, widths, nw, it, ncr, nur) = \
                jax.lax.while_loop(cond, body, init)
            width = widths / jnp.maximum(nw, 1)
            nc = ncr.astype(jnp.float32)
            return uf, Lf, done, idx0, nc, nur.astype(jnp.float32), width

        if walk_only:
            return spec_walk

        @jax.jit
        def run_population(key, live_u, live_L, nlive, axes, Lmin, scale,
                           treg):
            uf, Lf, done, idx0, nc, nu, width = spec_walk(
                key, live_u, live_L, nlive, axes, Lmin, scale, treg)
            rows = jnp.concatenate([
                uf, Lf[:, None], done[:, None].astype(jnp.float32),
                idx0[:, None].astype(jnp.float32)], axis=1)
            scalars = jnp.zeros((1, x_dim + 3), jnp.float32)
            scalars = scalars.at[0, 0].set(nc)
            scalars = scalars.at[0, 1].set(jnp.mean(done))
            scalars = scalars.at[0, 2].set(width)
            scalars = scalars.at[0, 3].set(nu)  # row width x_dim+3 >= 4
            return jnp.concatenate([rows, scalars], axis=0)

        if not segment:
            return run_population

        # --- segment kernel: walk + on-device consumption -------------
        # The walk's harvest is consumed into the live set inside the
        # same dispatch: a scan pops the worst live point for every
        # walker row that clears the rising threshold, emitting one
        # record per row. Live state stays device-resident between
        # dispatches, so successive segments chain with zero host
        # round trips and start from an exactly current live set.
        # (No buffer donation: on the cpu backend device arrays may
        # alias host numpy buffers, and donating those corrupts the
        # heap; the live state is ~100 KB, copies are negligible.)
        return self._compose_segment(spec_walk)

    def _build_async(self, npad, x_dim, popsize=None):
        """Asynchronous engine: walkers at independent chain positions.

        The lockstep engine (:meth:`_build`) advances all walkers through
        step k before any walker starts step k+1, so every shrink round
        costs ``popsize`` likelihood rows but only advances the walkers
        that have not yet accepted — the per-step cost is the *maximum*
        shrink count over the population (measured: ~12 evals/step for
        popsize=256 where the mean slice needs ~2.5).

        Here each walker holds its own (step index, direction, bracket)
        and every likelihood row advances its walker by one shrink
        iteration — the cost per step is the *mean* shrink count. Walkers
        that complete all ``nsteps`` freeze; the dispatch ends when
        ``harvest_frac`` of the population is done (or ``max_it * nsteps``
        rounds elapse). This is the device analogue of the per-walker
        generation counters in the reference's ``stepfuncs.pyx::evolve``
        (reference popstepsampler.py:509 ``advance``), without the
        worker-reassignment step so that detailed balance holds exactly
        per walker.
        """
        ev = self._treg_eval()
        P = popsize or self.popsize
        nsteps = self.nsteps
        max_rounds = self.max_it * nsteps
        target_done = max(1, int(np.ceil(self.harvest_frac * P)))

        @jax.jit
        def run_population(key, live_u, live_L, nlive, axes, Lmin, scale,
                           treg):
            kstart, kdir, kt = jax.random.split(key, 3)

            # All randomness is pre-generated in bulk OUTSIDE the loop:
            # per-round small RNG calls inside a while_loop body serialize
            # into latency-bound threefry chains on device.
            #  - tbank[r, i]: walker i's slice draw in round r
            #  - dirbank[s, i]: walker i's direction for its step s
            #    (directions depend on live points/axes only, never on
            #    the walker position, so they can be drawn up front)
            tbank = jax.random.uniform(kt, (max_rounds, P))
            kde1, kde2, kax, kchoice = jax.random.split(kdir, 4)
            i1 = jax.random.randint(kde1, (nsteps, P), 0, nlive)
            i2 = jax.random.randint(kde2, (nsteps, P), 0, nlive - 1)
            i2 = jnp.where(i2 >= i1, i2 + 1, i2)
            v_de = live_u[i1] - live_u[i2]
            jx = jax.random.randint(kax, (nsteps, P), 0, x_dim)
            v_ax = axes[jx]
            pick = jax.random.uniform(kchoice, (nsteps, P)) < 0.5
            dirbank = jnp.where(pick[..., None], v_de, v_ax) * scale

            idx0 = jax.random.randint(kstart, (P,), 0, nlive)
            u0 = live_u[idx0]
            L0 = live_L[idx0]
            v0 = dirbank[0]
            tl0, tr0 = _cube_intersection(u0, v0)

            def cond(state):
                (u, L, v, tl, tr, step, done, widths, nw, it, ncr) = state
                return jnp.logical_and(it < max_rounds,
                                       jnp.sum(done) < target_done)

            def body(state):
                (u, L, v, tl, tr, step, done, widths, nw, it, ncr) = state
                t = tl + tbank[it] * (tr - tl)
                up = u + t[:, None] * v
                Lp, tin = ev(up, treg)
                ncr = ncr + jnp.sum(jnp.logical_and(tin, ~done))
                acc = jnp.logical_and(Lp > Lmin, ~done)
                u = jnp.where(acc[:, None], up, u)
                L = jnp.where(acc, Lp, L)
                step = step + acc
                newly_done = jnp.logical_and(acc, step >= nsteps)
                # record final bracket widths of completing steps
                widths = widths + jnp.sum(jnp.where(acc, tr - tl, 0.0))
                nw = nw + jnp.sum(acc)
                done = jnp.logical_or(done, newly_done)
                # rejected active walkers shrink their bracket
                rej = jnp.logical_and(~acc, ~done)
                tl = jnp.where(jnp.logical_and(rej, t < 0), t, tl)
                tr = jnp.where(jnp.logical_and(rej, t >= 0), t, tr)
                # walkers advancing to their next step take their
                # pre-drawn direction and a fresh full-chord bracket
                renew = jnp.logical_and(acc, ~done)
                s = jnp.clip(step, 0, nsteps - 1)
                vn = jnp.take_along_axis(
                    dirbank, s[None, :, None], axis=0)[0]
                v = jnp.where(renew[:, None], vn, v)
                tln, trn = _cube_intersection(u, v)
                tl = jnp.where(renew, tln, tl)
                tr = jnp.where(renew, trn, tr)
                return (u, L, v, tl, tr, step, done, widths, nw, it + 1,
                        ncr)

            init = (u0, L0, v0, tl0, tr0, jnp.zeros(P, jnp.int32),
                    jnp.zeros(P, bool), jnp.float32(0.0),
                    jnp.int32(0), jnp.int32(0), jnp.int32(0))
            (uf, Lf, _, tl, tr, step, done, widths, nw, it, ncr) = \
                jax.lax.while_loop(cond, body, init)
            width = widths / jnp.maximum(nw, 1)
            nc = ncr.astype(jnp.float32)
            # Pack everything into ONE array: each array in a fetched
            # tuple costs a separate host<->device round trip, which
            # dominates wall time on high-latency links.
            rows = jnp.concatenate([
                uf, Lf[:, None], done[:, None].astype(jnp.float32),
                idx0[:, None].astype(jnp.float32)], axis=1)
            scalars = jnp.zeros((1, x_dim + 3), jnp.float32)
            scalars = scalars.at[0, 0].set(nc)
            scalars = scalars.at[0, 1].set(jnp.mean(done))
            scalars = scalars.at[0, 2].set(width)
            # every async-round evaluation advances its own walker's
            # actual chain: useful == billed
            scalars = scalars.at[0, 3].set(nc)
            return jnp.concatenate([rows, scalars], axis=0)

        return run_population

    def _build(self, npad, x_dim, popsize=None, walk_only=False):
        ev = self._treg_eval()
        P = popsize or self.popsize
        nsteps = self.nsteps
        max_it = self.max_it

        def sync_walk(key, live_u, live_L, nlive, axes, Lmin, scale, treg):
            kstart, ksteps = jax.random.split(key)
            idx0 = jax.random.randint(kstart, (P,), 0, nlive)
            u0 = live_u[idx0]
            L0 = live_L[idx0]

            def one_step(carry, key_s):
                u, L, nc = carry
                kde1, kde2, kax, kchoice, kshrink = \
                    jax.random.split(key_s, 5)

                # differential-evolution pair directions
                i1 = jax.random.randint(kde1, (P,), 0, nlive)
                i2 = jax.random.randint(kde2, (P,), 0, nlive - 1)
                i2 = jnp.where(i2 >= i1, i2 + 1, i2)
                v_de = live_u[i1] - live_u[i2]
                # region principal-axis directions
                jx = jax.random.randint(kax, (P,), 0, x_dim)
                v_ax = axes[jx]
                pick = jax.random.uniform(kchoice, (P,)) < 0.5
                v = jnp.where(pick[:, None], v_de, v_ax) * scale

                tl, tr = _cube_intersection(u, v)

                def cond(state):
                    tlc, trc, unew, Lnew, done, ncc, it, kk = state
                    return jnp.logical_and(it < max_it,
                                           ~jnp.all(done))

                def body(state):
                    tlc, trc, unew, Lnew, done, ncc, it, kk = state
                    kk, k1 = jax.random.split(kk)
                    t = tlc + jax.random.uniform(k1, (P,)) * (trc - tlc)
                    up = u + t[:, None] * v
                    Lp, tin = ev(up, treg)
                    ncc = ncc + jnp.sum(tin)
                    acc = jnp.logical_and(Lp > Lmin, ~done)
                    unew = jnp.where(acc[:, None], up, unew)
                    Lnew = jnp.where(acc, Lp, Lnew)
                    done2 = jnp.logical_or(done, acc)
                    rej = ~done2
                    tlc = jnp.where(jnp.logical_and(rej, t < 0), t, tlc)
                    trc = jnp.where(jnp.logical_and(rej, t >= 0), t, trc)
                    return (tlc, trc, unew, Lnew, done2, ncc, it + 1, kk)

                init = (tl, tr, u, L, jnp.zeros(P, bool), nc,
                        jnp.int32(0), kshrink)
                tlf, trf, unew, Lnew, done, nc, it, _ = \
                    jax.lax.while_loop(cond, body, init)
                width = jnp.median(trf - tlf)
                return (unew, Lnew, nc), (jnp.mean(done), width)

            (uf, Lf, nc), (acc_rates, widths) = jax.lax.scan(
                one_step, (u0, L0, jnp.int32(0)),
                jax.random.split(ksteps, nsteps))
            done = jnp.ones(P, bool)
            return (uf, Lf, done, idx0, nc.astype(jnp.float32),
                    jnp.mean(widths), jnp.mean(acc_rates))

        if walk_only:
            # drop the trailing acceptance-rate stat: the walk-only
            # convention is (uf, Lf, done, idx0, nc, nuseful, width);
            # lockstep rounds evaluate no speculative rows, so
            # useful == billed
            def walk(key, live_u, live_L, nlive, axes, Lmin, scale, treg):
                uf, Lf, done, idx0, nc, width, _ = sync_walk(
                    key, live_u, live_L, nlive, axes, Lmin, scale, treg)
                return uf, Lf, done, idx0, nc, nc, width
            return walk

        @jax.jit
        def run_population(key, live_u, live_L, nlive, axes, Lmin, scale,
                           treg):
            uf, Lf, done, idx0, nc, width, acc_rate = sync_walk(
                key, live_u, live_L, nlive, axes, Lmin, scale, treg)
            rows = jnp.concatenate([
                uf, Lf[:, None], done[:, None].astype(jnp.float32),
                idx0[:, None].astype(jnp.float32)], axis=1)
            scalars = jnp.zeros((1, x_dim + 3), jnp.float32)
            scalars = scalars.at[0, 0].set(nc)
            scalars = scalars.at[0, 1].set(acc_rate)
            scalars = scalars.at[0, 2].set(width)
            scalars = scalars.at[0, 3].set(nc)  # lockstep: no waste
            return jnp.concatenate([rows, scalars], axis=0)

        return run_population

    def _launch(self, region, Lmin, us, Ls, tregion=None):
        """Dispatch one population walk; returns a pending handle.

        The result array is NOT fetched here — the device computes and
        streams it to the host (``copy_to_host_async``) while the
        integrator keeps consuming the current buffer. One pending
        dispatch is kept in flight (see ``__next__``), hiding both the
        kernel time and the transfer latency of remote accelerators.
        """
        nlive, ndim = us.shape
        self._resolve_spec_depth(ndim)
        npad = round_up(nlive)
        live_u = pad_rows(np.asarray(us, np.float32), npad)
        live_L = pad_rows(np.asarray(Ls, np.float32), npad, fill=-np.inf)
        axes = np.asarray(region.transformLayer.axes, np.float32)
        if axes.ndim == 1:
            axes = np.diag(axes)
        self._sync_treg_key(tregion)
        kernel = self._get_kernel(npad, ndim)
        sub = self._next_key()
        args = (sub, live_u, live_L, np.int32(nlive), axes,
                np.float32(Lmin), np.float32(self.scale),
                self._pack_tregion(tregion))
        if self.nshards > 1:
            from .parallel.launch import is_multiprocess_mesh, put_args
            if is_multiprocess_mesh(self.mesh):
                from jax.sharding import PartitionSpec as PS
                args = put_args(self.mesh, (PS(),) * 8, args)
        out = kernel(*args)
        try:
            out.copy_to_host_async()
        except Exception:
            pass
        return out, np.array(us, np.float32, copy=True), self.nsteps

    def _harvest(self, region, transform, loglike, Lmin):
        """Fetch the pending dispatch and fill the sample buffer.

        The selected points are re-evaluated on the host in f64 before
        entering the tree; points at or below the *current* Lmin (which
        may have risen since launch) are discarded here.
        """
        out, us, at_nsteps = self._pending
        self._pending = None
        nlive, ndim = us.shape
        from .parallel.launch import fetch_replicated
        packed = fetch_replicated(out).astype(float)
        # column layout: [u(0:d), L, done, idx0]; one trailing scalar
        # row per shard: [ncall, done_frac, width] (f32-exact < 2**24)
        if self.nshards > 1:
            blocks = packed.reshape(self.nshards, -1, packed.shape[1])
            rows = blocks[:, :-1, :].reshape(-1, packed.shape[1])
            scal = blocks[:, -1, :]
            nc = int(scal[:, 0].sum())
            acc_rate = float(scal[:, 1].mean())
            width = float(scal[:, 2].mean())
            nu = int(scal[:, 3].sum())
        else:
            rows, scalars = packed[:-1], packed[-1]
            nc = int(scalars[0])
            acc_rate, width = scalars[1], scalars[2]
            nu = int(scalars[3])
        done = rows[:, ndim + 1] > 0.5
        uf = rows[:, :ndim][done]
        idx0 = rows[:, ndim + 2][done].astype(int)
        Lf = rows[:, ndim][done]
        self.ncalls += nc
        self.ncalls_useful += nu
        np.clip(uf, 1e-7, 1 - 1e-7, out=uf)
        # f64 re-evaluation before the points enter the tree
        pf = transform(uf)
        Lf64 = loglike(pf)
        ok = Lf64 > Lmin
        self.nrejects += int((~ok).sum())
        if len(ok) >= 32 and ok.mean() < 0.05 and \
                not getattr(self, '_warned_mismatch', False):
            self._warned_mismatch = True
            import warnings
            warnings.warn(
                'f64 re-evaluation rejects %.0f%% of device-accepted '
                'points: jax_loglike/jax_transform probably do not '
                'match the host loglike/transform (did you forget '
                'jax_transform?)' % (100 * (1 - ok.mean())))

        far_enough, (move_distance, reference_distance) = \
            diagnose_move_distances(region, us[idx0[ok] % nlive, :],
                                    uf[ok])
        _, cloud_ref = reference_sqdistance_info(region)
        gm_target = decorrelation_gm_target(uf.shape[1]) \
            if cloud_ref else None
        L_ok = Lf64[ok]
        self._buf = (uf[ok], pf[ok], L_ok)
        self._buf_i = 0
        self._buf_sufmax = np.maximum.accumulate(L_ok[::-1])[::-1] \
            if len(L_ok) else L_ok
        self._last_yield = max(len(L_ok), 1)
        self.logstat.append([
            float(ok.mean()) if len(ok) else 0.0,
            float(acc_rate),
            self.scale,
            float(at_nsteps),
            float(np.mean(far_enough)) if len(far_enough) else 0.0,
            float(np.exp(np.mean(np.log(
                move_distance / reference_distance + 1e-10))))
            if len(far_enough) else 0.0,
        ])
        if self.logfile:
            self.logfile.write("rescale\t%.4f\t%.4f\t%g\t%d\t%.4f\t%g\n"
                               % tuple(self.logstat[-1]))

        self._adapt_scale(width)
        self._adapt_nsteps(self.logstat[-1][-2], len(far_enough), at_nsteps,
                           rel_jump_gm=self.logstat[-1][-1],
                           gm_target=gm_target)
        return nc

    def _adapt_scale(self, width):
        """Adapt the slice length guess from the final interval width."""
        if self.scale_adapt_factor != 1.0:
            if width >= self.scale / self.adapt_slice_scale_target:
                self.scale /= self.scale_adapt_factor
            else:
                self.scale *= self.scale_adapt_factor

    # GM relative jump must reach this fraction of the decorrelated
    # target before the governor stops growing (cloud-variance
    # normalizer only). Calibrated with the DEVICE-normalized readings
    # (segmentops.whitened_cloud_var; evaluate/governor_signal_study.py):
    # gauss-100d sigma=0.01 reads gm/target 0.805/0.931/0.988 at
    # nsteps 100/200/400 (logZ +15.3/+2.8/+0.8), so the margin must
    # exceed 0.931 to reject the biased 200; asymgauss-12d reads
    # 0.838/0.960/1.004 at 16/32/64 (all unbiased), so 0.96 stops at
    # 32-64 there instead of doubling without bound.
    RELJUMP_MARGIN = 0.96

    def _adapt_nsteps(self, far_frac, nchains, at_nsteps,
                      rel_jump_gm=None, gm_target=None):
        """Govern the chain length from the jump-distance diagnostics.

        Device analogue of the reference's per-chain ``adapt_nsteps``
        (stepsampler.py:889-923), batched: one decision per dispatch,
        doubling on too-short chains (each nsteps change re-jits the
        kernels, so the step must be geometric, not the reference's
        ±10%% nudge). Records from dispatches launched at a previous
        nsteps are ignored (``at_nsteps`` gate), so queued stale
        batches cannot compound the doubling.

        Two growth criteria:

        - far-enough fraction < 0.5 (the reference's move-distance
          rule): most chains did not travel one decorrelation scale.
        - GM relative jump below ``RELJUMP_MARGIN * gm_target``, when
          the scale is the cloud variance (*gm_target* is not None):
          endpoints still correlate with their starts even though every
          chain cleared one cloud radius. In >~50 dimensions the jump
          distribution concentrates, so the far-enough fraction slams
          from 0 to 1 across a narrow nsteps range while ~20% residual
          correlation remains — a +1.4 sigma logZ bias on
          gauss100_hard without this criterion
          (evaluate/governor_signal_study.py).
        """
        if not self.adaptive_nsteps or at_nsteps != self.nsteps \
                or nchains < 8:
            return
        gm_low = gm_target is not None and rel_jump_gm is not None \
            and rel_jump_gm < self.RELJUMP_MARGIN * gm_target
        # The first dispatches after a growth event run with a slice
        # scale tuned for the OLD chain length and legitimately read
        # low: a grace period of 2 dispatches plus a 2-consecutive-low
        # streak requirement keep warm-up readings from overshooting by
        # another doubling (measured: 800 instead of 400 on
        # gauss100_hard, 2x the evals for the same logZ). A low reading
        # still blocks shrink even during grace.
        if gm_low and self._gm_grace > 0:
            self._gm_grace -= 1
            self._gm_low_streak = 0
        else:
            self._gm_low_streak = self._gm_low_streak + 1 if gm_low else 0
            if not gm_low:
                self._gm_grace = 0
        if (far_frac < 0.5 or self._gm_low_streak >= 2) \
                and self.nsteps < self.max_nsteps:
            self._nsteps_grew = True
            self._gm_low_streak = 0
            self._gm_grace = 2
            self._set_nsteps(min(self.max_nsteps, self.nsteps * 2))
        elif far_frac > 0.9 and not gm_low \
                and self.nsteps > self.nsteps_min \
                and not self._nsteps_grew:
            self._set_nsteps(max(self.nsteps_min,
                                 int(np.ceil(self.nsteps / 1.5))))

    def observe_insertion_ranks(self, ranks, nlive, rec_nsteps=None):
        """Grow nsteps when insertion ranks are detectably non-uniform.

        Second, independent growth signal for the ``adaptive_nsteps``
        governor (the first is the jump-distance far-enough fraction,
        :meth:`_adapt_nsteps`). The far-enough criterion measures chain
        travel relative to the region scale and can saturate while the
        chains are still too short to decorrelate the *likelihood rank*
        of their endpoints — measured on the 100-d sigma=0.01 gaussian,
        where it stops doubling at nsteps=200 with logZ biased +1.4
        sigma over seeds. The insertion-rank MWW U-test (ordertest.py;
        Buchner 2023 sec. 4.5.2, the same statistic the reference
        alarms on, cf. /root/reference/ultranest/integrator.py:2736-2746)
        detects exactly that failure: a 4-sigma detection over a
        popsize-scaled window doubles nsteps.

        The integrator feeds accepted-insertion ranks from replay
        (segment mode) or per-iteration (classic mode). *rec_nsteps* is
        the chain length the feeding batch was launched at: queued
        dispatches from before a growth event would otherwise re-fire
        the alarm on stale rows and compound the doubling.
        """
        if not self.adaptive_nsteps or nlive <= 1:
            return
        if rec_nsteps is not None and int(rec_nsteps) != self.nsteps:
            self._mww_acc.reset()
            return
        self._mww_acc.add_many(np.asarray(ranks), nlive)
        if self._mww_acc.N < self._mww_window:
            return
        zscore = self._mww_acc.zscore
        self._mww_acc.reset()
        if abs(zscore) > self._mww_zthreshold \
                and self.nsteps < self.max_nsteps:
            self._nsteps_grew = True
            self._gm_grace = 2
            if self.logfile:
                self.logfile.write("mww-alarm\t%.2f\n" % zscore)
            import logging
            logging.getLogger('ultranest_tpu.popfused').info(
                'adaptive nsteps: insertion-rank z=%.1f over %d ranks',
                zscore, self._mww_window)
            self._set_nsteps(min(self.max_nsteps, self.nsteps * 2))

    def _set_nsteps(self, nsteps):
        """Change nsteps, invalidating kernels (and the live seg kernel)."""
        if nsteps == self.nsteps:
            return
        import logging
        logging.getLogger('ultranest_tpu.popfused').info(
            'adaptive nsteps: %d -> %d', self.nsteps, nsteps)
        if self.logfile:
            self.logfile.write("adapt-nsteps\t%d\t%d\n"
                               % (self.nsteps, nsteps))
        self.nsteps = int(nsteps)
        self._kernel_cache.clear()
        if getattr(self, '_seg_kernel', None) is not None:
            self._seg_kernel = self._seg_get_kernel()

    # --- segment mode -----------------------------------------------
    # The integrator's segment fast path (integrator._explore_segments)
    # drives these instead of __next__: live state lives ON DEVICE and
    # chains across dispatches (donated buffers), each dispatch also
    # consuming its harvest into the live set (see _build_spec's
    # run_segment). The host receives one packed record array per
    # dispatch and replays it into the tree.

    segment_capable = True
    # p-space WrappingEllipsoid filtering is fused into the walk kernels,
    # so non-affine transforms keep the segment fast path
    segment_tregion_ok = True

    def segment_ok(self):
        """Segment mode runs on every population engine.

        The async engine routes through the spec kernel at speculative
        depth 1 (identical round semantics); sync exposes its walk in
        the shared walk-only convention. ``harvest_frac < 1`` is
        excluded: segment consumption bills every harvested row, so the
        dispatch must walk the whole population to completion.
        """
        return self.engine in ('spec', 'async', 'sync') \
            and self.harvest_frac >= 1.0

    @property
    def _segment_depth(self):
        return 1 if self.engine == 'async' else None

    def _build_walk_only(self, npad, x_dim, popsize=None):
        """Walk kernel with the segment calling convention.

        Returns ``walk(key, live_u, live_L, nlive, axes, Lmin, scale) ->
        (uf, Lf, done, idx0, nc, nuseful, width)``; subclasses with
        non-slice walks (rwalk) override this to join the segment
        machinery. ``nuseful`` counts the evaluations a strictly
        sequential sampler would have needed for the same accepted
        chains; engines without speculation report ``nuseful == nc``.
        """
        if self.engine == 'sync':
            return self._build(npad, x_dim, popsize=popsize,
                               walk_only=True)
        return self._build_spec(npad, x_dim, popsize=popsize,
                                walk_only=True, depth=self._segment_depth)

    def _compose_segment(self, walk):
        """Wrap a walk kernel with the shared consume/pack convention.

        Each chain's whitened squared travel distance (end vs the
        ``live_u[idx0]`` start, read before the consume scan mutates the
        live set) travels home as ONE trailing record column for the
        jump-distance diagnostic, instead of the d start coordinates
        (see :meth:`_pack_whiten`).
        """
        from .segmentops import (consume_scan, pack_segment,
                                 whitened_cloud_var, whitened_jump2)

        @jax.jit
        def run_segment(key, live_u, live_L, nlive, axes, scale, treg,
                        tpack):
            Lmin0 = jnp.min(live_L)          # padding is +inf
            uf, Lf, done, idx0, nc, nu, width = walk(
                key, live_u, live_L, nlive, axes, Lmin0, scale, treg)
            jump2 = whitened_jump2(live_u[idx0], uf, tpack)
            # decorrelation normalizer from the live cloud the chains
            # actually walked in (the host region snapshot is up to
            # queue-depth segments stale; see whitened_cloud_var)
            ref2 = whitened_cloud_var(live_u, nlive, tpack)
            live_u2, live_L2, recs = consume_scan(
                live_u, live_L, uf, Lf, done.astype(jnp.float32))
            recs = jnp.concatenate([recs, jump2[:, None]], axis=1)
            packed = pack_segment(uf, Lf, recs, nc, jnp.mean(done), width,
                                  nuseful=nu, ref2=ref2)
            return live_u2, live_L2, packed

        return run_segment

    def _build_segment_single(self, npad, x_dim):
        """Single-shard segment kernel (walk + consume in one dispatch)."""
        if self.engine == 'sync':
            return self._compose_segment(self._build_walk_only(npad, x_dim))
        return self._build_spec(npad, x_dim, segment=True,
                                depth=self._segment_depth)

    def _build_segment_sharded(self, npad, x_dim):
        """Mesh-sharded segment kernel: walk sharded, consume replicated.

        Each shard walks ``popsize / nshards`` walkers with
        ``fold_in``-derived RNG, the harvests are all_gathered, and
        every shard runs the identical consume scan over the full
        gathered batch — live state stays replicated bit-for-bit
        across shards, the SPMD equivalent of the reference's
        every-rank-holds-the-full-live-set invariant.
        """
        from jax.sharding import PartitionSpec as PS

        from .segmentops import (consume_scan, pack_segment,
                                 whitened_cloud_var, whitened_jump2)
        local_walk = self._build_walk_only(
            npad, x_dim, popsize=self.popsize // self.nshards)
        axis_name = self.axis_name

        def shard_fn(key, live_u, live_L, nlive, axes, scale, treg,
                     tpack):
            k = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            Lmin0 = jnp.min(live_L)
            uf, Lf, done, idx0, nc, nu, width = local_walk(
                k, live_u, live_L, nlive, axes, Lmin0, scale, treg)
            uf_all = jax.lax.all_gather(uf, axis_name, tiled=True)
            Lf_all = jax.lax.all_gather(Lf, axis_name, tiled=True)
            dn_all = jax.lax.all_gather(done.astype(jnp.float32),
                                        axis_name, tiled=True)
            # one scalar per local walker instead of d start coords:
            # cheaper over ICI, and the host payload shrinks the same way
            jump2 = whitened_jump2(live_u[idx0], uf, tpack)
            j2_all = jax.lax.all_gather(jump2, axis_name, tiled=True)
            nc_tot = jax.lax.psum(nc, axis_name)
            nu_tot = jax.lax.psum(nu, axis_name)
            width_m = jax.lax.pmean(width, axis_name)
            done_m = jax.lax.pmean(jnp.mean(done), axis_name)
            # live state is replicated: every shard computes the same
            # cloud variance bit-for-bit (no collective needed)
            ref2 = whitened_cloud_var(live_u, nlive, tpack)
            live_u2, live_L2, recs = consume_scan(
                live_u, live_L, uf_all, Lf_all, dn_all)
            recs = jnp.concatenate([recs, j2_all[:, None]], axis=1)
            packed = pack_segment(uf_all, Lf_all, recs, nc_tot, done_m,
                                  width_m, nuseful=nu_tot, ref2=ref2)
            return live_u2, live_L2, packed

        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh, in_specs=(PS(),) * 8,
            out_specs=(PS(), PS(), PS()), check_vma=False)
        return jax.jit(mapped)

    def _seg_get_kernel(self):
        """Build (or fetch cached) the segment kernel for the live shape."""
        npad, ndim = self._seg_npad, self._seg_ndim
        ck = ('seg', npad, ndim, self.nsteps, self._treg_key)
        th = self._seg_prewarm.get(ck)
        if th is not None and th.is_alive():
            # a speculative compile of exactly this kernel is in flight
            # (see _prewarm_next_nsteps): wait for it instead of racing
            # a duplicate build/compile on the main thread
            th.join()
        kernel = self._kernel_cache.get(ck)
        if kernel is None:
            from .fused import _kernel_cache_get

            def build_fn():
                if self.nshards > 1:
                    return self._build_segment_sharded(npad, ndim)
                return self._build_segment_single(npad, ndim)

            kernel = _kernel_cache_get(self._global_ck(ck), build_fn)
            self._kernel_cache[ck] = kernel
        return kernel

    def _prewarm_next_nsteps(self, args):
        """Speculatively compile the doubled-nsteps segment kernel.

        The adaptive governor only ever grows by exactly 2x
        (:meth:`_adapt_nsteps`), and a growth event invalidates the
        segment kernel — the next dispatch then blocks in XLA until the
        new kernel is compiled. Growth is predictable, so a daemon
        thread builds AND
        executes the doubled kernel on same-shaped arguments while the
        run proceeds; the growth event then picks the warm executable
        out of the process-level kernel cache. The dummy execution is
        discarded (costs one extra device dispatch per growth level).

        Multi-process meshes are excluded: every controller must launch
        the same programs in the same order, and a background dispatch
        on one controller would deadlock the collective.
        """
        if not self.adaptive_nsteps or self.nsteps >= self.max_nsteps:
            return
        if self.nshards > 1 and self.mesh is not None:
            from .parallel.launch import is_multiprocess_mesh
            if is_multiprocess_mesh(self.mesh):
                return
        nsteps2 = min(self.max_nsteps, self.nsteps * 2)
        ck = ('seg', self._seg_npad, self._seg_ndim, nsteps2,
              self._treg_key)
        if ck in self._seg_prewarm:
            return
        import copy
        import threading

        # a shallow copy shares the kernel caches (dict identity), so
        # the twin's build lands under the real growth-event keys
        twin = copy.copy(self)
        twin.nsteps = nsteps2
        # own registry: the twin's _seg_get_kernel must not try to join
        # the very thread it is running on
        twin._seg_prewarm = {}
        reg = self._seg_prewarm
        from .fused import _KERNEL_CACHE
        if ck in self._kernel_cache \
                or twin._global_ck(ck) in _KERNEL_CACHE:
            # already built this process (warm rerun): the executable
            # is warm too, skip the dummy dispatch
            reg[ck] = None
            return

        def body():
            try:
                out = twin._seg_get_kernel()(*args)
                jax.block_until_ready(out)
            except Exception:
                # speculative only: the growth event compiles for real
                reg.pop(ck, None)

        th = threading.Thread(target=body, daemon=True,
                              name='ultranest-prewarm-nsteps%d' % nsteps2)
        reg[ck] = th
        th.start()

    def segment_start(self, us, Ls, ndraw=None):
        """Upload the live set and prepare the segment kernel."""
        nlive, ndim = us.shape
        self._resolve_spec_depth(ndim)
        npad = round_up(nlive)
        self._seg_nlive = nlive
        self._seg_ndim = ndim
        self._seg_npad = npad
        self._seg_kernel = self._seg_get_kernel()
        lu = pad_rows(np.asarray(us, np.float32), npad)
        lL = pad_rows(np.asarray(Ls, np.float32), npad, fill=np.inf)
        from .fused import _device_put_maybe_global
        self._seg_state = (
            _device_put_maybe_global(lu, self.mesh),
            _device_put_maybe_global(lL, self.mesh))
        self._seg_queue = []
        # device state supersedes any buffered classic-mode harvest
        self._buf = None
        self._buf_i = 0
        self._pending = None

    def segment_launch(self, region, tregion=None):
        """Dispatch one chained walk+consume segment (non-blocking)."""
        axes = np.asarray(region.transformLayer.axes, np.float32)
        if axes.ndim == 1:
            axes = np.diag(axes)
        self._seg_region = region
        if self._sync_treg_key(tregion):
            # tregion appeared/vanished since the kernel was built
            self._seg_kernel = self._seg_get_kernel()
        extra = (self._next_key(), np.int32(self._seg_nlive), axes,
                 np.float32(self.scale), self._pack_tregion(tregion),
                 self._pack_whiten(region))
        if self.nshards > 1:
            from .parallel.launch import is_multiprocess_mesh, put_args
            if is_multiprocess_mesh(self.mesh):
                from jax.sharding import PartitionSpec as PS
                extra = put_args(self.mesh, (PS(),) * 6, extra)
        key, nlive32, axes_g, scale_g, treg_g, tpack_g = extra
        lu, lL, packed = self._seg_kernel(
            key, self._seg_state[0], self._seg_state[1],
            nlive32, axes_g, scale_g, treg_g, tpack_g)
        self._seg_state = (lu, lL)
        try:
            packed.copy_to_host_async()
        except Exception:
            pass
        self._seg_queue.append((packed, self.nsteps, region))
        self._prewarm_next_nsteps(
            (key, lu, lL, nlive32, axes_g, scale_g, treg_g, tpack_g))

    def segment_fetch(self):
        """Block on the oldest queued segment; returns parsed records.

        Returns a dict with per-row arrays (in consumption order):
        ``u (P,d), L, accept, worst, Lmin, rank, plateau, dup,
        jump2 (P,)`` — the whitened squared chain travel distance,
        computed on device (:func:`segmentops.whitened_jump2`) — and
        the scalars ``nc`` (walk evaluations), ``done_frac``,
        ``width``. Also feeds the jump-distance diagnostics (one
        logstat row per dispatch) and the adaptive nsteps governor,
        exactly as the classic-mode harvest does.
        """
        from .parallel.launch import fetch_replicated
        out, at_nsteps, region = self._seg_queue.pop(0)
        packed = fetch_replicated(out).astype(float)
        d = self._seg_ndim
        rows, scal = packed[:-1], packed[-1]
        # guard against f32 rounding onto the cube boundary (the classic
        # harvest clips the same way; region construction requires
        # strictly interior points)
        np.clip(rows[:, :d], 1e-7, 1 - 1e-7, out=rows[:, :d])
        flags = rows[:, d + 5]
        rec = dict(
            u=rows[:, :d], L=rows[:, d],
            accept=rows[:, d + 1] > 0.5,
            worst=rows[:, d + 2].astype(np.int64),
            Lmin=rows[:, d + 3],
            rank=rows[:, d + 4].astype(np.int64),
            plateau=flags >= 2, dup=(flags % 2) >= 1,
            jump2=rows[:, d + 6],
            nc=int(scal[0]), done_frac=float(scal[1]),
            width=float(scal[2]), nc_useful=int(scal[3]),
            ref2_dev=float(scal[4]) if len(scal) > 4 else 0.0,
            nsteps=int(at_nsteps))
        self.ncalls += rec['nc']
        self.ncalls_useful += rec['nc_useful']
        self._adapt_scale(rec['width'])
        self._segment_diagnose(rec, at_nsteps, region)
        return rec

    def _segment_diagnose(self, rec, at_nsteps, region):
        """Jump-distance diagnostics + nsteps adaptation per dispatch.

        The whitened squared travel distance arrives precomputed from
        the device (``rec['jump2']``), and so does the cloud-variance
        normalizer (``rec['ref2_dev']``,
        :func:`segmentops.whitened_cloud_var`): chained dispatches run
        up to queue-depth segments past the host's region snapshot, and
        normalizing by the snapshot's (larger, stale) variance read the
        GM relative jump low by ``exp(-consumed/(nlive*ndim))`` — in
        moderate dimension that gap (1.27 measured vs 1.40 true at
        12-d) kept the nsteps governor doubling without bound. The
        MLFriends ball-radius branch keeps the host scale: that radius
        is the reference's own far-enough semantics, not a cloud
        statistic.
        """
        acc = rec['accept']
        n = int(acc.sum())
        if n == 0 or region is None:
            return
        d2 = rec['jump2'][acc]
        ref2, cloud_ref = reference_sqdistance_info(region)
        if cloud_ref and rec.get('ref2_dev', 0.0) > 0.0:
            ref2 = rec['ref2_dev']
        far_frac = float(np.mean(d2 > ref2))
        rel_jump_gm = float(np.exp(np.mean(
            0.5 * np.log(d2 / ref2 + 1e-20))))
        self.logstat.append([
            float(np.mean(acc)),
            rec['done_frac'],
            self.scale,
            float(at_nsteps),
            far_frac,
            rel_jump_gm,
        ])
        if self.logfile:
            self.logfile.write("rescale\t%.4f\t%.4f\t%g\t%d\t%.4f\t%g\n"
                               % tuple(self.logstat[-1]))
        gm_target = decorrelation_gm_target(region.unormed.shape[1]) \
            if cloud_ref else None
        self._adapt_nsteps(far_frac, n, at_nsteps,
                           rel_jump_gm=rel_jump_gm, gm_target=gm_target)

    def segment_pending(self):
        """Number of dispatches in flight."""
        q = getattr(self, '_seg_queue', None)
        return len(q) if q else 0

    def segment_stop(self):
        """Leave segment mode, dropping device state and queued work."""
        self._seg_state = None
        self._seg_queue = None
        self._seg_kernel = None

    # rows handed to the integrator per __next__ call: batching the
    # handoff amortizes the per-call python overhead of the integrator's
    # buffer machinery (measured 3.5 calls/iteration when handing out
    # single rows); small enough that threshold staleness stays low
    HANDOFF_CHUNK = 64

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Return the next prepared samples as a chunk (u, p, L, nc).

        Hands out up to ``HANDOFF_CHUNK`` buffered rows at once (the
        integrator consumes them from its own buffer, re-checking each
        against the current threshold on insertion). Refills from the
        pending device dispatch when the buffer runs out, and — once the
        buffer is down to ~30% of the last harvest — launches the NEXT
        dispatch early so the device computes and streams results while
        the integrator consumes the remainder.
        """
        nc = 0
        if self._buf_remaining() == 0:
            if self._pending is None:
                assert us is not None, \
                    'refill needed but live points were not provided ' \
                    '(needs_live_points contract violated)'
                self._pending = self._launch(region, Lmin, us, Ls,
                                             tregion=tregion)
            nc = self._harvest(region, transform, loglike, Lmin)
            if self._buf_remaining() == 0:
                return None, None, None, nc
        if self._pending is None and us is not None and \
                jax.default_backend() != 'cpu' and \
                self._buf_remaining() <= max(1, int(0.3 * self._last_yield)):
            self._pending = self._launch(region, Lmin, us, Ls,
                                         tregion=tregion)
        i = self._buf_i
        j = min(i + self.HANDOFF_CHUNK, len(self._buf[2]))
        self._buf_i = j
        bu, bp, bL = self._buf
        return bu[i:j], bp[i:j], bL[i:j], nc


class FusedPopulationRandomWalkSampler(FusedPopulationSliceSampler):
    """Device-resident population Metropolis random walk.

    Device counterpart of
    :class:`ultranest_tpu.popstepsampler.PopulationRandomWalkSampler`
    (reference popstepsampler.py:178-298): every walker performs
    ``nsteps`` Gaussian steps in region-axes space, accepting moves above
    the likelihood threshold. One ``lax.scan`` over steps with one
    batched likelihood call per step runs the whole population walk in a
    single dispatch; the scale adapts towards a target acceptance rate
    between dispatches.

    Proposal kernel, shard_map distribution, prefetch pipeline, packed
    single-array harvest and f64 re-evaluation are shared with the slice
    engine.
    """

    def __init__(self, popsize, nsteps, jax_loglike, jax_transform=None,
                 scale=1.0, scale_adapt_factor=0.9, target_acceptance=0.234,
                 seed=0, logfile=None, mesh=None, axis_name=None,
                 adaptive_nsteps=False, max_nsteps=1000):
        super().__init__(
            popsize, nsteps, jax_loglike, jax_transform=jax_transform,
            scale=scale, scale_adapt_factor=scale_adapt_factor, seed=seed,
            logfile=logfile, engine='rwalk', mesh=mesh, axis_name=axis_name,
            adaptive_nsteps=adaptive_nsteps, max_nsteps=max_nsteps)
        self.target_acceptance = target_acceptance

    def __str__(self):
        """Return string representation."""
        return ('FusedPopulationRandomWalkSampler(popsize=%d, nsteps=%d, '
                'scale=%g)' % (self.popsize, self.nsteps, self.scale))

    def _build_rwalk(self, npad, x_dim, popsize=None, walk_only=False):
        ev = self._treg_eval()
        P = popsize or self.popsize
        nsteps = self.nsteps

        def rwalk(key, live_u, live_L, nlive, axes, Lmin, scale, treg):
            kstart, keps = jax.random.split(key)
            idx0 = jax.random.randint(kstart, (P,), 0, nlive)
            u0 = live_u[idx0]
            L0 = live_L[idx0]
            # all proposal noise drawn in bulk outside the loop
            eps = jax.random.normal(keps, (nsteps, P, x_dim))

            def one_step(carry, eps_s):
                u, L, nacc, nc = carry
                up = u + scale * jnp.dot(
                    eps_s, axes.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
                inside = jnp.logical_and(up > 0, up < 1).all(axis=1)
                Lev, tin = ev(up, treg)
                Lp = jnp.where(inside, Lev, -jnp.inf)
                acc = jnp.logical_and(inside, Lp > Lmin)
                u = jnp.where(acc[:, None], up, u)
                L = jnp.where(acc, Lp, L)
                return (u, L, nacc + jnp.sum(acc),
                        nc + jnp.sum(jnp.logical_and(inside, tin))), None

            (uf, Lf, nacc, nc), _ = jax.lax.scan(
                one_step, (u0, L0, jnp.int32(0), jnp.int32(0)), eps)
            acc_rate = nacc / jnp.float32(P * nsteps)
            done = jnp.ones(P, bool)
            ncf = nc.astype(jnp.float32)
            # the "width" statistics slot carries the acceptance rate:
            # _adapt_scale is overridden accordingly; Metropolis rounds
            # evaluate no speculative rows (useful == billed)
            return uf, Lf, done, idx0, ncf, ncf, acc_rate

        if walk_only:
            return rwalk

        @jax.jit
        def run_population(key, live_u, live_L, nlive, axes, Lmin, scale,
                           treg):
            uf, Lf, done, idx0, nc, nu, acc_rate = rwalk(
                key, live_u, live_L, nlive, axes, Lmin, scale, treg)
            rows = jnp.concatenate([
                uf, Lf[:, None], done[:, None].astype(jnp.float32),
                idx0[:, None].astype(jnp.float32)], axis=1)
            scalars = jnp.zeros((1, x_dim + 3), jnp.float32)
            scalars = scalars.at[0, 0].set(nc)
            scalars = scalars.at[0, 1].set(acc_rate)
            scalars = scalars.at[0, 2].set(acc_rate)
            scalars = scalars.at[0, 3].set(nu)
            return jnp.concatenate([rows, scalars], axis=0)

        return run_population

    def segment_ok(self):
        """The rwalk engine always walks the full population: segment-ok."""
        return True

    def _build_walk_only(self, npad, x_dim, popsize=None):
        return self._build_rwalk(npad, x_dim, popsize=popsize,
                                 walk_only=True)

    def _build_segment_single(self, npad, x_dim):
        return self._compose_segment(self._build_walk_only(npad, x_dim))

    def _adapt_scale(self, acceptance_rate):
        """Steer the proposal scale towards the target acceptance rate."""
        if self.scale_adapt_factor == 1.0:
            return
        if acceptance_rate < self.target_acceptance:
            self.scale *= self.scale_adapt_factor
        else:
            self.scale /= self.scale_adapt_factor
