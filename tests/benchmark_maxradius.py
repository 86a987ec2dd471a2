"""Micro-benchmark of the region kernels across dimensionality and size.

Mirrors the reference harness (`tests/benchmark_maxradius.py`): times the
bootstrapped radius computation, layer transform and membership test over
a grid of (ndim, npoints). Run directly::

    python tests/benchmark_maxradius.py

``--crossover`` instead times each host route against the default
device for the two size thresholds that choose between them
(``ops.pairwise.HOST_WORK_THRESHOLD``: host numpy against a device
dispatch; ``ops.bootstrap.CPU_WORK_THRESHOLD``: the radius kernel on
XLA:CPU against the device), and prints the work at which the device
starts to win.
"""
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def _median_s(fn, reps=15):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def crossover():
    """Host-vs-device timings for the two routing thresholds."""
    import jax

    from ultranest_tpu.ops.bootstrap import (_cpu_device, _radius_kernel,
                                             make_bootstrap_masks)
    from ultranest_tpu.ops.pairwise import (_maxradius_masked, _np_sqdist,
                                            pad_rows, round_up)

    print('device:', jax.devices()[0].device_kind)
    rng = np.random.RandomState(1)
    first = None
    print('%6s %6s %12s %10s %10s' % ('ndim', 'npts', 'work', 'host[ms]',
                                      'device[ms]'))
    for ndim in (2, 8, 32):
        for npts in (64, 128, 256, 512, 1024, 2048, 4096):
            a = rng.uniform(size=(npts, ndim)).astype(np.float32)
            npd = round_up(npts)
            mask = pad_rows(np.ones(npts, bool), npd, False)
            ap = pad_rows(a, npd)
            t_host = _median_s(
                lambda: float(_np_sqdist(a, a).min(axis=0).max()))
            t_dev = _median_s(
                lambda: float(_maxradius_masked(ap, mask, ap, mask)))
            work = npts * npts * ndim
            print('%6d %6d %12d %10.3f %10.3f' % (ndim, npts, work,
                                                  1e3 * t_host, 1e3 * t_dev))
            if t_dev < t_host and (first is None or work < first):
                first = work
    print('pairwise: device first wins at work %s' % first)

    cpu = _cpu_device()
    first = None
    print('%6s %6s %12s %10s %10s' % ('ndim', 'npts', 'work', 'xlacpu[ms]',
                                      'device[ms]'))
    for ndim in (2, 16):
        for npts in (128, 256, 512, 1024, 2048, 4096):
            t = rng.uniform(size=(npts, ndim)).astype(np.float32)
            masks = make_bootstrap_masks(npts, 30, rng=rng)
            npd = round_up(npts)
            valid = pad_rows(np.ones(npts, bool), npd, False)
            tp = pad_rows(t, npd)
            mk = np.zeros((len(masks), npd), dtype=bool)
            mk[:, :npts] = masks

            def on_cpu():
                with jax.default_device(cpu):
                    return float(_radius_kernel(tp, valid, mk))

            t_cpu = _median_s(on_cpu, reps=5)
            t_dev = _median_s(lambda: float(_radius_kernel(tp, valid, mk)))
            work = npd * npd * max(len(mk), ndim)
            print('%6d %6d %12d %10.3f %10.3f' % (ndim, npts, work,
                                                  1e3 * t_cpu, 1e3 * t_dev))
            if t_dev < t_cpu and (first is None or work < first):
                first = work
    print('bootstrap radius: device first wins at work %s' % first)


def main():
    from ultranest_tpu.mlfriends import AffineLayer, MLFriends
    from ultranest_tpu.ops.bootstrap import (bootstrap_radius_enlargement,
                                             make_bootstrap_masks)

    print('%6s %6s %12s %12s %12s' % (
        'ndim', 'npts', 'radius[ms]', 'transform[ms]', 'inside[ms]'))
    for ndim in [2, 4, 8, 16, 32, 64]:
        for npts in [100, 400, 1000, 4000]:
            rng = np.random.RandomState(1)
            u = rng.uniform(0.3, 0.7, size=(npts, ndim))
            layer = AffineLayer()
            layer.optimize(u, u)
            region = MLFriends(u, layer)
            masks = make_bootstrap_masks(npts, 30, rng=rng)

            # warm up the jit caches
            bootstrap_radius_enlargement(u, region.unormed, masks)
            nrep = 3
            t0 = time.time()
            for _ in range(nrep):
                maxd, maxf, ok = bootstrap_radius_enlargement(
                    u, region.unormed, masks)
            t_radius = (time.time() - t0) / nrep * 1000

            q = rng.uniform(0.3, 0.7, size=(1000, ndim))
            t0 = time.time()
            for _ in range(nrep):
                layer.transform(q)
            t_transform = (time.time() - t0) / nrep * 1000

            region.maxradiussq = maxd
            region.enlarge = maxf
            region.create_ellipsoid()
            region.inside(q)
            t0 = time.time()
            for _ in range(nrep):
                region.inside(q)
            t_inside = (time.time() - t0) / nrep * 1000

            print('%6d %6d %12.2f %12.3f %12.2f' % (
                ndim, npts, t_radius, t_transform, t_inside))


if __name__ == '__main__':
    if '--crossover' in sys.argv:
        crossover()
    else:
        main()
