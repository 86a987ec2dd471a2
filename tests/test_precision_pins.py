"""The f32 dots that feed the governor and the walk ask for full precision.

On the GPU an f32 product without a stated precision may run in TF32
(10-bit mantissa). The whitened jump distance and cloud variance feed
the adaptive-nsteps governor, whose margin separates biased from
unbiased chain lengths by a few per cent, and the random-walk direction
moves every walker. Each test traces its function under
``jax.default_matmul_precision('bfloat16')``: every dot in the program
must still say HIGHEST (the CPU backend ignores the setting, so the
program, not the numbers, shows a lost pin), and the values must match
float64.
"""
import numpy as np

import jax
import jax.numpy as jnp


def _dot_precisions(fn, *args):
    """Precision of every dot_general in the traced program of *fn*."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == 'dot_general':
                found.append(eqn.params['precision'])
            for v in eqn.params.values():
                for item in v if isinstance(v, (tuple, list)) else (v,):
                    inner = getattr(item, 'jaxpr', item)
                    if hasattr(inner, 'eqns'):
                        walk(inner)

    with jax.default_matmul_precision('bfloat16'):
        walk(jax.make_jaxpr(fn)(*args).jaxpr)
    assert found, 'no dot in the program'
    return found


def _assert_highest(fn, *args):
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    for p in _dot_precisions(fn, *args):
        assert p == highest, p


def _tpack(rng, d):
    cloud = rng.normal(size=(4 * d, d)) * rng.uniform(0.01, 0.2, d)
    w, v = np.linalg.eigh(np.cov(cloud, rowvar=False))
    T = (v * w ** -0.5).astype(np.float32)
    return np.vstack([T, np.zeros((1, d), np.float32)])


def test_whitened_jump2_pinned():
    from ultranest_tpu.segmentops import whitened_jump2
    rng = np.random.default_rng(0)
    d = 50
    tpack = _tpack(rng, d)
    u0 = rng.uniform(0.3, 0.7, (256, d)).astype(np.float32)
    uf = (u0 + rng.normal(0, 0.05, (256, d))).astype(np.float32)
    _assert_highest(whitened_jump2, u0, uf, tpack)
    with jax.default_matmul_precision('bfloat16'):
        got = np.asarray(jax.jit(whitened_jump2)(u0, uf, tpack))
    ref = (((uf.astype(np.float64) - u0) @ tpack[:-1]) ** 2).sum(axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_whitened_cloud_var_pinned():
    from ultranest_tpu.segmentops import whitened_cloud_var
    rng = np.random.default_rng(1)
    d, nlive = 50, 400
    tpack = _tpack(rng, d)
    live = rng.uniform(0.3, 0.7, (512, d)).astype(np.float32)
    _assert_highest(whitened_cloud_var, live, np.int32(nlive), tpack)
    with jax.default_matmul_precision('bfloat16'):
        got = float(jax.jit(whitened_cloud_var)(live, np.int32(nlive),
                                                tpack))
    w = live[:nlive].astype(np.float64) @ tpack[:-1]
    ref = ((w - w.mean(axis=0)) ** 2).sum() / nlive
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_random_walk_direction_pinned():
    """One Metropolis step, every proposal accepted: the end point is
    exactly u0 + scale * eps @ axes.T."""
    from ultranest_tpu.popfused import FusedPopulationRandomWalkSampler
    d, P, npad = 20, 128, 64
    ss = FusedPopulationRandomWalkSampler(
        popsize=P, nsteps=1,
        jax_loglike=lambda x: jnp.zeros(x.shape[0], jnp.float32))
    walk = ss._build_rwalk(npad, d, walk_only=True)
    rng = np.random.default_rng(2)
    live_u = rng.uniform(0.45, 0.55, (npad, d)).astype(np.float32)
    axes = (0.01 * rng.normal(size=(d, d))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    args = (key, live_u, np.zeros(npad, np.float32), np.int32(npad), axes,
            np.float32(-np.inf), np.float32(0.5), np.zeros(1, np.float32))
    _assert_highest(walk, *args)
    with jax.default_matmul_precision('bfloat16'):
        uf, _, _, idx0, _, _, acc = jax.jit(walk)(*args)
    assert float(acc) == 1.0
    kstart, keps = jax.random.split(key)
    eps = np.asarray(jax.random.normal(keps, (1, P, d)))[0]
    ref = live_u[np.asarray(idx0)].astype(np.float64) \
        + 0.5 * eps.astype(np.float64) @ axes.T.astype(np.float64)
    np.testing.assert_allclose(np.asarray(uf), ref, rtol=0, atol=2e-7)


def test_sharded_proposal_pinned():
    from ultranest_tpu.parallel import make_mesh, parallel_propose_evaluate
    d = 8
    mesh = make_mesh(2)
    propose = parallel_propose_evaluate(
        mesh, lambda v: -jnp.sum(v * v, axis=1), lambda u: u, d,
        ndraw_per_shard=32)
    args = (np.asarray(jax.random.split(jax.random.PRNGKey(0), 2)),
            np.full(d, 0.5, np.float32), np.eye(d, dtype=np.float32) * 0.2,
            np.eye(d, dtype=np.float32) * 25.0, np.float32(4.0),
            np.float32(-1e10))
    _assert_highest(propose, *args)
