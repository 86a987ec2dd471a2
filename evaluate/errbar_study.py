#!/usr/bin/env python
"""Error-bar study: why is high-d logzerr wider than the reference anchor?

Round-3 verdict: gauss100 logzerr 1.71 vs the reference's 0.85
(/root/reference/docs/performance.rst:327-335); asymgauss50 1.23 vs the
same-machine CPU child's 0.70 at equal ncall. Suspects:

1. batch correlation: a segment dispatch consumes ``popsize`` rows
   against ``nlive`` live points; at popsize >> nlive, late rows come
   from chains whose starts predate several live-set turnovers ->
   bootstrap ensemble spreads. Measured here by sweeping popsize at
   fixed nsteps.
2. chain length: nsteps-limited decorrelation widens the spread for
   every popsize. Measured by sweeping nsteps.
3. seed noise: logzerr_bs is a MAX over ~30 bootstrap counters — a
   noisy statistic. Measured by repeating seeds.

Usage: python evaluate/errbar_study.py [--problem gauss100|asymgauss50]
           [--popsizes 2048,512] [--nsteps 400] [--seeds 3,4,5]
Writes one JSON line per run to stdout.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--problem', default='gauss100')
    ap.add_argument('--popsizes', default='2048')
    ap.add_argument('--nsteps', default='400')
    ap.add_argument('--seeds', default='3')
    ap.add_argument('--adaptive', action='store_true')
    ap.add_argument('--sigma', type=float, default=None)
    ap.add_argument('--classic', action='store_true',
                    help='disable the segment fast path (classic loop)')
    ap.add_argument('--platform', default=None)
    args = ap.parse_args()

    if args.platform:
        # read by jax when it is first imported (below, through bench)
        os.environ['JAX_PLATFORMS'] = args.platform
    import bench

    from ultranest_tpu import models
    if args.problem == 'gauss100':
        prob = models.gauss(ndim=100, sigma=args.sigma or 0.01)
    elif args.problem == 'asymgauss50':
        prob = models.asymgauss(ndim=50, sigma_min=args.sigma or 0.01)
    else:
        raise SystemExit('unknown problem %s' % args.problem)

    orig = bench.__dict__['_run_popfused']

    def run(prb, seed, **kw):
        if not args.classic:
            return orig(prb, seed, **kw)
        # same sampler, segment fast path disabled -> classic loop
        import ultranest_tpu.popfused as pf
        old = pf.FusedPopulationSliceSampler.segment_ok
        pf.FusedPopulationSliceSampler.segment_ok = lambda self: False
        try:
            return orig(prb, seed, **kw)
        finally:
            pf.FusedPopulationSliceSampler.segment_ok = old

    for popsize in [int(x) for x in args.popsizes.split(',')]:
        for nsteps in [int(x) for x in args.nsteps.split(',')]:
            for seed in [int(x) for x in args.seeds.split(',')]:
                t0 = time.time()
                row = run(
                    prob, seed, popsize=popsize, nsteps=nsteps,
                    adaptive_nsteps=args.adaptive)
                row.update(problem=args.problem, popsize=popsize,
                           nsteps=nsteps, seed=seed,
                           adaptive=bool(args.adaptive),
                           classic=bool(args.classic),
                           sigma=args.sigma,
                           wall_total=time.time() - t0)
                print('ROW ' + json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in row.items()}), flush=True)


if __name__ == '__main__':
    main()
