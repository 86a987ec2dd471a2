"""Fixed cost of one shrink round of the spec walk on this device.

Times the spec engine's walk kernel at speculation depth 1 and depth 8
with a near-free likelihood, at popsize 4096 and d = 50, with a
population that never completes (``harvest_frac=2``), so the walk runs
exactly its round cap. Per-round time at depth D is ``A + D * t_row``;
the two depths give ``t_row`` and the fixed overhead ``A``, the
``round_overhead_s`` of :func:`ultranest_tpu.popfused.optimal_spec_depth`::

    python evaluate/measure_spec_round.py

``--ab OLD_S`` instead runs the asymgauss 50-d bench configuration with
the spec-depth auto-tuner at round overhead OLD_S and at the current
:data:`~ultranest_tpu.popfused.ROUND_OVERHEAD_S`, in turns (old, new,
new, old) after one warm-up of each, and prints wall, billed and useful
evaluations and the depth each selected.
"""

import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def per_round(depth, popsize=4096, ndim=50, nlive=400, nsteps=10, reps=20):
    """Median seconds per shrink round of the spec walk at *depth*."""
    import jax
    import jax.numpy as jnp

    from ultranest_tpu.ops.pairwise import pad_rows, round_up
    from ultranest_tpu.popfused import FusedPopulationSliceSampler

    ss = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps,
        jax_loglike=lambda x: -0.5 * jnp.sum(x * x, axis=1),
        engine='spec', spec_depth=depth, harvest_frac=2.0)
    npad = round_up(nlive)
    walk = jax.jit(ss._build_spec(npad, ndim, walk_only=True, depth=depth))
    max_rounds = nsteps * max(4, (ss.max_it + depth - 1) // depth)
    rng = np.random.default_rng(1)
    live_u = pad_rows(rng.uniform(0.4, 0.6, (nlive, ndim)).astype(
        np.float32), npad)
    live_L = pad_rows(np.zeros(nlive, np.float32), npad, fill=-np.inf)
    args = (jax.random.PRNGKey(0), live_u, live_L, np.int32(nlive),
            np.eye(ndim, dtype=np.float32) * 0.05, np.float32(-np.inf),
            np.float32(1.0), np.zeros(1, np.float32))
    jax.block_until_ready(walk(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(walk(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / max_rounds, max_rounds


def depth_ab(old_s):
    """asymgauss 50-d with the auto-tuner at *old_s* vs the current A."""
    import bench
    import ultranest_tpu.popfused as popfused
    new_s = popfused.ROUND_OVERHEAD_S

    def run(overhead):
        popfused.ROUND_OVERHEAD_S = overhead
        row = bench.run_asymgauss50(seed=1)
        (t_row,) = popfused._PROBE_CACHE.values()
        depth = popfused.optimal_spec_depth(t_row, 8)
        print('round_overhead %.1f us: depth %d (t_row %.2f us), wall %.4f '
              's, ncall %d, useful %d, logz %.3f +- %.3f'
              % (1e6 * overhead, depth, 1e6 * t_row, row['wall_s'],
                 row['ncall'], row['ncall_useful'], row['logz'],
                 row['logzerr']), flush=True)

    run(old_s)
    run(new_s)
    print('-- timed turns')
    for overhead in (old_s, new_s, new_s, old_s):
        run(overhead)
    popfused.ROUND_OVERHEAD_S = new_s


def main():
    import jax

    import bench
    print('device:', jax.devices()[0].device_kind, '|',
          bench.nvidia_smi_line(), flush=True)
    if '--ab' in sys.argv:
        return depth_ab(float(sys.argv[sys.argv.index('--ab') + 1]))
    t1, r1 = per_round(1)
    t8, r8 = per_round(8)
    t_row = max(0.0, (t8 - t1) / 7)
    overhead = t1 - t_row
    print('spec walk P=4096 d=50: depth 1 %.2f us/round (%d rounds), '
          'depth 8 %.2f us/round (%d rounds)' % (1e6 * t1, r1, 1e6 * t8, r8))
    print('t_row %.3f us, round_overhead_s %.3e' % (1e6 * t_row, overhead))


if __name__ == '__main__':
    main()
