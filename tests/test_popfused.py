"""Device-resident population slice sampler tests."""
import numpy as np
import pytest

from ultranest_tpu import ReactiveNestedSampler, models
from ultranest_tpu.mlfriends import ScalingLayer, SimpleRegion
from ultranest_tpu.popfused import FusedPopulationSliceSampler


def test_gauss_2d():
    prob = models.gauss(ndim=2, sigma=0.1)
    sampler = ReactiveNestedSampler(seed=1,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=64, nsteps=8, jax_loglike=prob.jax_loglike, seed=1)
    res = sampler.run(min_num_live_points=100, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.1)
    assert abs(res['logz'] - prob.logz) < 1.0, res['logz']
    info = sampler.stepsampler.get_info_dict()
    assert info['frac_far_enough'] > 0.5


def test_asymgauss_highdim():
    ndim = 16
    prob = models.asymgauss(ndim=ndim, sigma_min=0.02)
    sampler = ReactiveNestedSampler(seed=2,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.transform_layer_class = ScalingLayer
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=128, nsteps=2 * ndim, jax_loglike=prob.jax_loglike, seed=2)
    res = sampler.run(min_num_live_points=200, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.1,
                      region_class=SimpleRegion, cluster_num_live_points=0)
    assert abs(res['logz'] - prob.logz) < 3 * max(res['logzerr'], 0.5), \
        (res['logz'], res['logzerr'])


def test_sync_engine_agrees():
    """The lockstep reference engine gives the same evidence."""
    prob = models.gauss(ndim=2, sigma=0.1)
    sampler = ReactiveNestedSampler(seed=1,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=64, nsteps=8, jax_loglike=prob.jax_loglike, seed=1,
        engine='sync')
    res = sampler.run(min_num_live_points=100, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.1)
    assert abs(res['logz'] - prob.logz) < 1.0, res['logz']


def test_async_cheaper_than_sync():
    """The async engine needs fewer likelihood rows per produced point."""
    prob = models.asymgauss(ndim=8, sigma_min=0.02)
    ncalls = {}
    for engine in ('async', 'sync'):
        sampler = ReactiveNestedSampler(seed=4,
                                        **prob.sampler_kwargs(use_jax=False))
        sampler.transform_layer_class = ScalingLayer
        sampler.stepsampler = FusedPopulationSliceSampler(
            popsize=128, nsteps=16, jax_loglike=prob.jax_loglike, seed=4,
            engine=engine)
        res = sampler.run(min_num_live_points=200, viz_callback=False,
                          show_status=False, max_num_improvement_loops=0,
                          min_ess=0, dlogz=2.0, frac_remain=0.1,
                          region_class=SimpleRegion,
                          cluster_num_live_points=0)
        assert abs(res['logz'] - prob.logz) < 3 * max(res['logzerr'], 0.5), \
            (engine, res['logz'], res['logzerr'])
        ncalls[engine] = res['ncall'] / res['niter']
    assert ncalls['async'] < 0.7 * ncalls['sync'], ncalls


def test_transform_is_applied():
    prob = models.eggbox()
    sampler = ReactiveNestedSampler(seed=3,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=64, nsteps=6, jax_loglike=prob.jax_loglike,
        jax_transform=prob.jax_transform, seed=3)
    res = sampler.run(min_num_live_points=200, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.5, max_ncalls=500000)
    assert abs(res['logz'] - prob.logz) < 3.0, (res['logz'], prob.logz)


def test_fused_random_walk_sampler_gauss():
    """Device random-walk population sampler solves an 8-d gaussian."""
    from ultranest_tpu import ReactiveNestedSampler, models
    from ultranest_tpu.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_tpu.popfused import FusedPopulationRandomWalkSampler

    prob = models.asymgauss(ndim=8, sigma_min=0.02)
    sampler = ReactiveNestedSampler(seed=9,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.transform_layer_class = ScalingLayer
    sampler.stepsampler = FusedPopulationRandomWalkSampler(
        popsize=128, nsteps=40, jax_loglike=prob.jax_loglike, seed=9,
        scale=0.1)
    res = sampler.run(min_num_live_points=200, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.1,
                      region_class=SimpleRegion, cluster_num_live_points=0)
    assert abs(res['logz'] - prob.logz) < 3 * max(res['logzerr'], 0.5), \
        (res['logz'], res['logzerr'], prob.logz)
    # scale adapted away from its start value
    assert sampler.stepsampler.scale != 0.1


@pytest.mark.slow
def test_spec_engine_bias_audit():
    """Repeated-seed unbiasedness of the speculative-shrink engine.

    The round-2 headline showed one +1.5 sigma logZ reading; this is the
    gating audit (cf. /root/reference/tests/test_run.py:311-315): the
    mean z-score over seeds must be compatible with zero.
    """
    import sys
    sys.path.insert(0, '.')
    from evaluate.bias_audit import PROBLEMS, run_one

    rows = [run_one(PROBLEMS['asymgauss15'], seed) for seed in range(1, 7)]
    z = np.array([(r['logz'] - r['truth']) / r['logzerr'] for r in rows])
    assert abs(z.mean()) < 2.5 / np.sqrt(len(z)) + 1e-9, (z, z.mean())


def _run_counting(engine, spec_depth=None, seed=9):
    prob = models.gauss(ndim=6, sigma=0.05)
    sampler = ReactiveNestedSampler(seed=seed,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.transform_layer_class = ScalingLayer
    kw = {} if spec_depth is None else dict(spec_depth=spec_depth)
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=64, nsteps=12, jax_loglike=prob.jax_loglike, seed=seed,
        engine=engine, **kw)
    sampler.run(min_num_live_points=100, viz_callback=False,
                show_status=False, max_num_improvement_loops=0,
                min_ess=0, dlogz=2.0, frac_remain=0.1,
                region_class=SimpleRegion, cluster_num_live_points=0)
    return sampler.stepsampler


def test_useful_evals_strictly_below_billed_under_speculation():
    """spec_depth>1 bills speculative rows; useful counts must exclude
    the rows conditioned on rejections that did not happen."""
    ss = _run_counting('spec', spec_depth=8)
    assert ss.ncalls > 0
    assert 0 < ss.ncalls_useful < ss.ncalls, \
        (ss.ncalls_useful, ss.ncalls)


def test_useful_evals_equal_billed_without_speculation():
    """Depth-1 speculation degenerates to the async round semantics:
    every billed row advanced its walker's actual chain."""
    ss = _run_counting('spec', spec_depth=1)
    assert ss.ncalls > 0
    assert ss.ncalls_useful == ss.ncalls, (ss.ncalls_useful, ss.ncalls)
    for engine in ('sync', 'async'):
        ss = _run_counting(engine)
        assert ss.ncalls > 0
        assert ss.ncalls_useful == ss.ncalls, \
            (engine, ss.ncalls_useful, ss.ncalls)


def test_optimal_spec_depth_decisions():
    """Depth economics: free likelihoods keep the configured depth,
    expensive ones select 1, near-ties keep the configuration."""
    from ultranest_tpu.popfused import ROUND_OVERHEAD_S, optimal_spec_depth
    # the model depends on the likelihood cost only relative to the
    # round overhead
    A = ROUND_OVERHEAD_S
    assert optimal_spec_depth(0.0, 8) == 8
    assert optimal_spec_depth(30 * A, 8) == 1     # 30x the round overhead
    assert optimal_spec_depth(10e-3, 8, round_overhead_s=350e-6) == 1
    # an order of magnitude below the round overhead: modeled near-tie,
    # keep config
    assert optimal_spec_depth(A / 12, 8) == 8
    # monotone: cost never selects a depth ABOVE the configured one
    assert optimal_spec_depth(1e-3, 4) <= 4


def test_spec_depth_auto_lowers_for_slow_likelihood():
    """An artificially slow likelihood must select depth 1:
    speculation multiplies billed rows for a latency saving an
    expensive likelihood cannot benefit from."""
    import jax
    import jax.numpy as jnp

    def slow_ll(t):
        def body(i, acc):
            return acc + jnp.sin(t + i * 1e-3).sum(axis=1) * 1e-12
        return -0.5 * (((t - 0.5) / 0.1) ** 2).sum(axis=1) \
            + jax.lax.fori_loop(0, 3000, body, jnp.zeros(t.shape[0]))

    ss = FusedPopulationSliceSampler(
        popsize=256, nsteps=8, jax_loglike=slow_ll, seed=1,
        engine='spec', spec_depth=8, spec_depth_auto=True)
    ss._resolve_spec_depth(4)
    assert ss.spec_depth == 1, ss.spec_depth
    # resolution is one-time
    ss.spec_depth = 8
    ss._resolve_spec_depth(4)
    assert ss.spec_depth == 8


def test_spec_depth_auto_keeps_cheap_likelihood_default():
    import jax.numpy as jnp
    ss = FusedPopulationSliceSampler(
        popsize=64, nsteps=8,
        jax_loglike=lambda t: -jnp.sum(t * t, axis=1), seed=1,
        engine='spec', spec_depth=8, spec_depth_auto=True)
    ss._resolve_spec_depth(2)
    # a trivial likelihood must never select depth 1: the probe's
    # point is protecting expensive models, not changing cheap ones
    assert ss.spec_depth >= 4, ss.spec_depth


def test_spec_depth_auto_off_on_cpu_by_default():
    import jax.numpy as jnp
    ss = FusedPopulationSliceSampler(
        popsize=64, nsteps=8,
        jax_loglike=lambda t: -jnp.sum(t * t, axis=1), seed=1,
        engine='spec', spec_depth=8)
    ss._resolve_spec_depth(2)   # spec_depth_auto=None + CPU backend
    assert ss.spec_depth == 8
