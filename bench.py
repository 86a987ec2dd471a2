#!/usr/bin/env python
"""Benchmark: the reference's headline problems, end-to-end.

Headline (timed, warm):

1. **eggbox** (2-d, 18 modes; reference examples/testeggbox.py): reactive
   nested sampling with the fused device rejection-sampling path,
   logZ checked against quadrature.
2. **asymgauss 50-d** (reference examples/testasymgauss.py): the
   device-resident segment engine — each dispatch walks a whole
   population through all its slice steps AND consumes the harvest into
   the live set on device (:mod:`ultranest_tpu.segmentops`); live state
   chains across dispatches with a depth-2 queue. logZ is analytically
   0.

Protocol: each headline problem runs once to warm up (jit compilation
and program load) and then three times timed; the fastest timed run is
reported. The CPU baseline child (``--child``, ``JAX_PLATFORMS=cpu``, a
labelled column that never opens the GPU) uses the identical protocol.

Extras (warm-up run, then one timed run): rosenbrock-8d, multishell-8d,
loggamma-30d, gauss-100d — the remaining BASELINE.md problem set plus
the reference's high-dimensional anchor, with logZ correctness checks
where analytic truth exists.

The accelerator section runs in this process and fails when JAX finds
no GPU. Every record names the device (platform, ``device_kind``,
count) and the card's name and power limit as ``nvidia-smi`` reports
them. Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
...}; the full record goes to ``bench_out/bench_last_full.json``
(``--out`` to change).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def nvidia_smi_line():
    """``name, power.limit`` of the GPU(s), read by a child process
    that stays off JAX (None where nvidia-smi is missing)."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def device_record():
    """What JAX runs on, as every bench and smoke record names it."""
    import jax
    dev = jax.devices()[0]
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), nvidia_smi=nvidia_smi_line())


def eggbox_logz_expected():
    """Quadrature reference for the eggbox logZ."""
    n = 4000
    x = (np.arange(n) + 0.5) / n * 10 * np.pi
    chi = np.outer(np.cos(x / 2), np.cos(x / 2))
    logl = (2 + chi) ** 5
    m = logl.max()
    return float(np.log(np.exp(logl - m).mean()) + m)


def _result_row(results, wall):
    return dict(wall_s=wall, ncall=int(results['ncall']),
                niter=int(results['niter']), logz=float(results['logz']),
                logzerr=float(results['logzerr']),
                evals_per_s=results['ncall'] / wall)


def run_eggbox(use_jax, seed=42):
    import jax.numpy as jnp

    from ultranest_tpu import ReactiveNestedSampler

    def loglike(z):
        chi = np.cos(z[:, 0] / 2) * np.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def transform(x):
        return x * 10 * np.pi

    def jax_loglike(z):
        chi = jnp.cos(z[:, 0] / 2) * jnp.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def jax_transform(x):
        return x * 10 * jnp.pi

    sampler = ReactiveNestedSampler(
        ['x', 'y'], loglike, transform=transform, vectorized=True,
        seed=seed,
        jax_loglike=jax_loglike if use_jax else None,
        jax_transform=jax_transform if use_jax else None,
        ndraw_min=4096 if use_jax else 128,
        ndraw_max=32768 if use_jax else 65536)
    t0 = time.time()
    results = sampler.run(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=0.5, frac_remain=0.1,
        Lepsilon=0.001, max_ncalls=400000)
    row = _result_row(results, time.time() - t0)
    phases = getattr(sampler, '_segment_phase_s', None)
    if phases:
        # the phase breakdown shows where the wall goes
        row['phases'] = dict(phases)
    return row


def _run_popfused(prob, seed, popsize, nsteps, min_live=400, dlogz=2.0,
                  **sampler_kw):
    from ultranest_tpu import ReactiveNestedSampler
    from ultranest_tpu.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_tpu.popfused import FusedPopulationSliceSampler

    sampler = ReactiveNestedSampler(seed=seed,
                                    **prob.sampler_kwargs(use_jax=False))
    sampler.transform_layer_class = ScalingLayer
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, jax_loglike=prob.jax_loglike,
        jax_transform=getattr(prob, 'jax_transform', None),
        seed=seed, engine='spec', spec_depth=8, **sampler_kw)
    t0 = time.time()
    results = sampler.run(
        min_num_live_points=min_live, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=dlogz, frac_remain=0.1,
        region_class=SimpleRegion, cluster_num_live_points=0)
    row = _result_row(results, time.time() - t0)
    ss = sampler.stepsampler
    if getattr(ss, 'ncalls_useful', 0) and getattr(ss, 'ncalls', 0):
        # honest throughput next to billed throughput: the speculative
        # engine bills every evaluated row, including rows conditioned
        # on rejections that did not happen; useful counts only the
        # evaluations a sequential sampler would have needed for the
        # same accepted chains. ncall includes non-stepsampler calls
        # (initial live points, f64 re-checks), so subtract the waste.
        waste = ss.ncalls - ss.ncalls_useful
        row['ncall_useful'] = int(results['ncall']) - int(waste)
        row['useful_evals_per_s'] = row['ncall_useful'] / row['wall_s']
    phases = getattr(sampler, '_segment_phase_s', None)
    if phases:
        # segment-engine wall breakdown: fetch = blocked on device,
        # launch = dispatch cost, replay = host tree replay, rebuild =
        # region refresh (docs/performance.md "phase profile")
        row['phases'] = dict(phases)
    row['nsteps_final'] = int(sampler.stepsampler.nsteps)
    return row


def run_asymgauss50(use_jax=True, seed=1):
    # popsize 4096: not measured on the H100 (a popsize sweep is an
    # open benchmark item)
    from ultranest_tpu import models
    prob = models.asymgauss(ndim=50, sigma_min=0.01)
    return _run_popfused(prob, seed, popsize=4096, nsteps=100)


def run_extras(seed=3, skip_slow=False):
    from ultranest_tpu import models
    out = {}

    def warm_timed(prob, **kw):
        # same warm protocol as the headlines: the first run absorbs
        # jit compiles of this problem's shape buckets
        _run_popfused(prob, seed, **kw)
        return _run_popfused(prob, seed, **kw)

    prob = models.rosenbrock(ndim=8)
    out['rosenbrock8'] = warm_timed(prob, popsize=128, nsteps=16)
    prob = models.multishell(ndim=8)
    out['multishell8'] = warm_timed(prob, popsize=128, nsteps=16)
    out['multishell8']['logz_expected'] = float(prob.logz) \
        if getattr(prob, 'logz', None) is not None else None
    prob = models.loggamma(ndim=30)
    out['loggamma30'] = warm_timed(prob, popsize=256, nsteps=60)
    # the reference's high-dimensional anchor: 100-d gaussian with
    # sigma=0.1 (docs/gauss.py default used for the transcript),
    # RegionSliceSampler nsteps=100, N=400 -> logZ 1.043 +- 0.846 after
    # "a few hours on my laptop" (/root/reference/docs/performance.rst:
    # 218-223,327-335; /root/reference/docs/gauss.py:11). No hand-tuned
    # chain length: the run starts at the reference's nsteps=100 and
    # the jump-distance governor doubles it only if chains are too
    # short. Same-problem parity: logzerr ~0.7-1.0 (BENCH extras).
    if not skip_slow:
        prob = models.gauss(ndim=100, sigma=0.1)
        out['gauss100'] = warm_timed(prob, popsize=2048,
                                     nsteps=100, adaptive_nsteps=True)
        # hard variant: sigma=0.01 (H ~ 331 nats, 3.3x the anchor's
        # information). Expected logzerr ~ 1.7 here is information-
        # theoretic — max over ~30 bootstrap counters at spread
        # sqrt(H/nlive) ~ 0.9 — not a sampler defect (measured study in
        # docs/performance.md). Fixed nsteps=100 would silently return
        # logZ +17 on this variant; the governor doubles its way out.
        prob = models.gauss(ndim=100, sigma=0.01)
        out['gauss100_hard'] = _run_popfused(
            prob, seed, popsize=2048, nsteps=100, adaptive_nsteps=True)
    return out


def run_all(extras=False, skip_slow_extras=False):
    """All problems on JAX's default backend, in this process."""
    import jax
    use_jax = jax.default_backend() != 'cpu'
    stats = dict(backend=jax.default_backend())

    # warm + best-of-three protocol: the first run absorbs compilation
    # and the per-process device program load; of the timed runs the
    # fastest is reported
    def best_of(fn, n=3):
        rows = [fn(use_jax) for _ in range(n)]
        return min(rows, key=lambda r: r['wall_s'])

    run_eggbox(use_jax, seed=7)
    stats['eggbox'] = best_of(run_eggbox)
    run_asymgauss50(use_jax, seed=5)
    stats['asymgauss50'] = best_of(run_asymgauss50)
    if extras:
        stats['extras'] = run_extras(skip_slow=skip_slow_extras)
    return stats


def cpu_baseline():
    """The CPU-backend baseline, run by a child that never opens the GPU."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--child'],
        capture_output=True, text=True, timeout=3600, env=env, cwd=ROOT)
    for line in out.stdout.splitlines():
        if line.startswith('CHILD_RESULT '):
            return json.loads(line[len('CHILD_RESULT '):])
    raise RuntimeError('CPU baseline child failed (rc=%d): %s'
                       % (out.returncode, out.stderr[-2000:]))


def main():
    if '--child' in sys.argv:
        stats = run_all()
        print('CHILD_RESULT ' + json.dumps(stats))
        return
    out_path = os.path.join(ROOT, 'bench_out', 'bench_last_full.json')
    if '--out' in sys.argv:
        out_path = os.path.abspath(sys.argv[sys.argv.index('--out') + 1])

    device = device_record()
    if device['platform'] != 'gpu':
        sys.exit('bench.py measures the GPU, and JAX found none '
                 '(platform %r)' % device['platform'])
    eggbox_expected = eggbox_logz_expected()
    stats = run_all(extras=True)
    baseline = cpu_baseline()

    ag = stats['asymgauss50']
    egg = stats['eggbox']
    vs_baseline = ag['evals_per_s'] / baseline['asymgauss50']['evals_per_s']

    extras = stats.get('extras', {})
    logz_ok = dict(
        eggbox=bool(abs(egg['logz'] - eggbox_expected)
                    < max(4 * egg['logzerr'], 1.0)),
        asymgauss50=bool(abs(ag['logz']) < max(4 * ag['logzerr'], 1.5)))
    if 'multishell8' in extras:
        ms = extras['multishell8']
        if ms.get('logz_expected') is not None:
            logz_ok['multishell8'] = bool(
                abs(ms['logz'] - ms['logz_expected'])
                < max(4 * ms['logzerr'], 1.0))
    if 'loggamma30' in extras:
        lg = extras['loggamma30']
        logz_ok['loggamma30'] = bool(
            abs(lg['logz']) < max(4 * lg['logzerr'], 1.5))
    for key in ('gauss100', 'gauss100_hard'):
        if key in extras:
            g1 = extras[key]
            # the reference's own 100-d window: 1.04 +- 0.85 around 0
            logz_ok[key] = bool(
                abs(g1['logz']) < max(4 * g1['logzerr'], 2.0))

    def _round(d):
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in d.items()}

    # the stdout line stays a compact summary; the complete record
    # (phases, useful-evals columns, the whole CPU baseline) goes to a
    # file
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump({
            'device': device, 'stats': stats, 'baseline_cpu': baseline,
            'eggbox_logz_expected': eggbox_expected,
            'logz_ok': logz_ok,
            'protocol': ('headline problems: one warm-up run, then best '
                         'of three timed runs, identically for the GPU '
                         'and the CPU-backend baseline child'),
        }, f, indent=1, default=float)

    def _brief(row, keys=('wall_s', 'ncall', 'logz', 'logzerr',
                          'evals_per_s', 'useful_evals_per_s',
                          'nsteps_final')):
        return _round({k: row[k] for k in keys if k in row})

    print(json.dumps({
        'metric': 'asymgauss50d_likelihood_evals_per_s',
        'value': round(ag['evals_per_s'], 1),
        'unit': 'evals/s',
        'vs_baseline': round(vs_baseline, 3),
        'extra': {
            'device': device,
            'asymgauss50': {**_brief(ag),
                            'phases': ag.get('phases')},
            'eggbox': {**_brief(egg), 'phases': egg.get('phases')},
            'extras': {k: _brief(v) for k, v in extras.items()},
            'logz_ok': logz_ok,
            'baseline_cpu': {
                k: round(baseline[k]['evals_per_s'], 1)
                for k in ('eggbox', 'asymgauss50')},
            'full_record': os.path.relpath(out_path, ROOT),
        },
    }))


if __name__ == '__main__':
    main()
