"""Multi-host (2-axis hosts x devices mesh) execution tests.

The reference has no machine topology awareness at all — MPI ranks are
flat (reference ultranest/integrator.py:1148-1159). Here a
multi-host job is a 2-axis ('hosts', 'ranks') mesh: the engines shard
work over BOTH axes and the tuple-axis collectives are decomposed
hierarchically by XLA (within a host first, then across hosts).

Because the per-shard RNG folds in the LINEAR device index and tiled
all_gathers concatenate in the same row-major order, a (2, 4) mesh must
produce bitwise identical results to an 8-device 1-axis mesh — topology
must never change the statistics, only the interconnect routing.
"""
import numpy as np

import jax

from ultranest_tpu.parallel import make_mesh, mesh_axes


def np_loglike(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def jax_loglike(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def test_make_mesh_2d():
    mesh = make_mesh(shape=(2, 4), axis_name=('hosts', 'ranks'))
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ('hosts', 'ranks')
    assert mesh_axes(mesh) == ('hosts', 'ranks')
    assert mesh_axes(make_mesh(4)) == 'ranks'


def test_slice_mesh_single_process_fallback():
    from ultranest_tpu.parallel.launch import slice_mesh
    mesh = slice_mesh()
    # single-process job: all devices share one process -> 1 x N
    assert mesh.axis_names == ('hosts', 'ranks')
    assert mesh.devices.shape[0] == 1
    assert mesh.devices.size == len(jax.devices())


def test_2axis_fused_sampler_matches_1axis_bitwise():
    """Same seed, same device count: (2,4) mesh == 8-device mesh."""
    from ultranest_tpu import ReactiveNestedSampler

    def run(mesh):
        sampler = ReactiveNestedSampler(
            ['a', 'b'], np_loglike, transform=lambda x: np.asarray(x),
            vectorized=True, seed=12, jax_loglike=jax_loglike,
            ndraw_min=1024, ndraw_max=4096, mesh=mesh)
        res = sampler.run(min_num_live_points=100, viz_callback=False,
                          show_status=False, max_num_improvement_loops=0,
                          min_ess=0, dlogz=2.0, frac_remain=0.1)
        return res['logz'], res['niter'], sampler.ncall

    flat = run(make_mesh(8))
    twoax = run(make_mesh(shape=(2, 4), axis_name=('hosts', 'ranks')))
    assert flat == twoax, (flat, twoax)
    expected = np.log(2 * np.pi * 0.1**2)
    assert abs(flat[0] - expected) < 1.0, (flat[0], expected)


def test_2axis_population_sampler_matches_1axis_bitwise():
    from ultranest_tpu import ReactiveNestedSampler, models
    from ultranest_tpu.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_tpu.popfused import FusedPopulationSliceSampler
    prob = models.asymgauss(ndim=8, sigma_min=0.02)

    def run(mesh):
        sampler = ReactiveNestedSampler(
            seed=5, **prob.sampler_kwargs(use_jax=False))
        sampler.transform_layer_class = ScalingLayer
        sampler.stepsampler = FusedPopulationSliceSampler(
            popsize=128, nsteps=16, jax_loglike=prob.jax_loglike, seed=5,
            mesh=mesh)
        assert sampler.stepsampler.nshards == 8
        res = sampler.run(min_num_live_points=200, viz_callback=False,
                          show_status=False, max_num_improvement_loops=0,
                          min_ess=0, dlogz=2.0, frac_remain=0.1,
                          region_class=SimpleRegion,
                          cluster_num_live_points=0)
        return res['logz'], res['niter'], sampler.ncall

    twoax = run(make_mesh(shape=(2, 4), axis_name=('hosts', 'ranks')))
    flat = run(make_mesh(8))
    assert flat == twoax, (flat, twoax)
    assert abs(flat[0] - prob.logz) < 3.0, (flat[0], prob.logz)


def test_2axis_bootstrap_radius_matches_single_device():
    from ultranest_tpu.ops.bootstrap import (_bootstrap_radius,
                                             make_bootstrap_masks)
    rng = np.random.RandomState(7)
    tpoints = rng.normal(size=(300, 6))
    masks = make_bootstrap_masks(len(tpoints), 32, rng=rng)
    mesh = make_mesh(shape=(2, 4), axis_name=('hosts', 'ranks'))
    r_single = _bootstrap_radius(tpoints, masks)
    r_sharded = _bootstrap_radius(tpoints, masks, mesh=mesh)
    np.testing.assert_allclose(r_sharded, r_single, rtol=1e-6)


def test_2axis_strategy_kl_table_matches_host():
    from ultranest_tpu.parallel.strategy import bootstrap_kl_table
    rng = np.random.RandomState(11)
    niter, nboot = 400, 30
    ref = np.log(rng.dirichlet(np.ones(niter))).reshape((-1, 1))
    other = np.log(rng.dirichlet(np.ones(niter), size=nboot)).T
    KL_host, KLtot_host = bootstrap_kl_table(ref, other, mesh=None)
    mesh = make_mesh(shape=(2, 4), axis_name=('hosts', 'ranks'))
    KL_dev, KLtot_dev = bootstrap_kl_table(ref, other, mesh=mesh)
    np.testing.assert_allclose(KL_dev, KL_host, atol=1e-6)
    np.testing.assert_allclose(KLtot_dev, KLtot_host, atol=1e-4)
