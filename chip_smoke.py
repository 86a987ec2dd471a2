#!/usr/bin/env python
"""Smoke test: the nested sampler's main path, end to end, on the GPU.

    python chip_smoke.py              # one GPU: phases 0-4
    python chip_smoke.py --chips 4    # four GPUs of one host: the mesh
                                      # path and what it is compared with
    python chip_smoke.py --rehearse   # any backend, small sizes, no result
                                      # line (a dry run of the control flow)

Phases of the one-GPU run, all in this process:

0. device: kind and count, ``nvidia-smi`` name and power limit, jax
   versions, the compile-cache directory, the native C helpers;
1. kernels against a numpy float64 reference at real widths: the fused
   rejection path's membership test and the governor's whitening dots;
2. fused rejection path, eggbox (``bench.run_eggbox``), run twice, the
   second timed; logZ gated against quadrature;
3. segment engine with the device population sampler, asymgauss 50-d
   (``bench.run_asymgauss50``), run twice, the second timed; logZ gated;
4. adaptive-nsteps governor, gauss 100-d, sigma 0.1; logZ gated.

Every line but the last is a report; the last is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. The script
exits non-zero, with no such line, when JAX finds no GPU, when a phase
raises, or when a gate fails.
"""

import json
import os
import sys
import time

import numpy as np

# tolerances of the kernel comparisons
MEMBER_BAND = 1e-6     # membership may differ only where |d2-r2| <= this*r2
DOT_RTOL = 1e-5        # whitening dots against float64


def require_gpu(count=1):
    """The JAX devices, or RuntimeError unless *count* GPUs are there."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise RuntimeError('chip_smoke.py needs a GPU; JAX found platform '
                           '%r' % devices[0].platform)
    if len(devices) < count:
        raise RuntimeError('chip_smoke.py --chips %d needs %d GPUs; JAX '
                           'found %d' % (count, count, len(devices)))
    return devices


def check(ok, what):
    """Raise unless *ok*: a failed gate ends the run with no result."""
    if not ok:
        raise RuntimeError('check failed: %s' % what)


def report(name, **fields):
    print('[%s] %s' % (name, json.dumps(fields, default=float)), flush=True)


def cache_event_counter():
    """Count jax's persistent compile-cache events from now on."""
    import collections

    import jax
    events = collections.Counter()

    def listener(event, **kwargs):
        if event.startswith('/jax/compilation_cache/'):
            events[event.rsplit('/', 1)[1]] += 1

    jax.monitoring.register_event_listener(listener)
    return events


def phase_device():
    import jax
    import jaxlib

    import bench
    from ultranest_tpu import native
    dev = jax.devices()[0]
    report('device', platform=dev.platform, kind=dev.device_kind,
           count=len(jax.devices()), nvidia_smi=bench.nvidia_smi_line(),
           jax=jax.__version__, jaxlib=jaxlib.__version__,
           compile_cache=jax.config.jax_compilation_cache_dir,
           native_helpers='built' if native.available() else 'numpy')


def member_reference(tpoints, tmask, cands, r2):
    """float64 brute force: (member, min squared distance) per candidate."""
    tp = tpoints[tmask].astype(np.float64)
    mind = np.full(len(cands), np.inf)
    for lo in range(0, len(cands), 4096):
        c = cands[lo:lo + 4096].astype(np.float64)
        d2 = np.zeros((len(tp), len(c)))
        for k in range(tp.shape[1]):
            d2 += (tp[:, k, None] - c[None, :, k]) ** 2
        mind[lo:lo + 4096] = d2.min(axis=0)
    return mind <= r2, mind


def check_membership(sizes):
    """Fused membership test against float64, at (N, nvalid, M, d) sizes."""
    import jax

    from ultranest_tpu.fused import _radius_member
    member = jax.jit(_radius_member)
    rng = np.random.default_rng(11)
    worst = 0
    for n, nvalid, m, d in sizes:
        tpoints = rng.normal(size=(n, d)).astype(np.float32)
        tmask = np.arange(n) < nvalid
        # candidates near live points, so that about half are members
        near = tpoints[rng.integers(0, nvalid, m)]
        cands = (near + rng.normal(size=(m, d))).astype(np.float32)
        _, mind = member_reference(tpoints, tmask, cands, np.inf)
        r2 = np.float32(np.median(mind))
        expect, mind = member_reference(tpoints, tmask, cands, float(r2))
        got = np.asarray(member(cands, tpoints, tmask, r2))
        borderline = np.abs(mind - float(r2)) <= MEMBER_BAND * float(r2)
        wrong = int(((got != expect) & ~borderline).sum())
        worst = max(worst, wrong)
        report('kernel.membership', N=n, valid=nvalid, M=m, d=d,
               members=int(expect.sum()), mismatches=wrong,
               borderline=int(borderline.sum()),
               tolerance='booleans equal outside |d2-r2| <= %g r2'
               % MEMBER_BAND)
    check(worst == 0, 'membership differs from float64 off the borderline')


def whitening_pack(rng, d):
    """(d+1, d) pack of a realistic whitening matrix + no wrapped dims."""
    cloud = rng.normal(size=(4 * d, d)) * rng.uniform(0.01, 0.2, d)
    w, v = np.linalg.eigh(np.cov(cloud, rowvar=False))
    T = (v * w ** -0.5).astype(np.float32)
    return np.vstack([T, np.zeros((1, d), np.float32)])


def check_whitening(dims, popsize=4096, npad=512, nlive=400):
    """segmentops' whitening dots against float64 at rtol DOT_RTOL."""
    import jax

    from ultranest_tpu.segmentops import whitened_cloud_var, whitened_jump2
    jump2 = jax.jit(whitened_jump2)
    cloud_var = jax.jit(whitened_cloud_var)
    rng = np.random.default_rng(12)
    worst = 0.0
    for d in dims:
        tpack = whitening_pack(rng, d)
        T = tpack[:-1].astype(np.float64)
        u0 = rng.uniform(0.3, 0.7, (popsize, d)).astype(np.float32)
        uf = (u0 + rng.normal(0, 0.05, (popsize, d))).astype(np.float32)
        got = np.asarray(jump2(u0, uf, tpack), np.float64)
        ref = (((uf.astype(np.float64) - u0) @ T) ** 2).sum(axis=1)
        err_jump = float(np.max(np.abs(got - ref) / ref))
        live = rng.uniform(0.3, 0.7, (npad, d)).astype(np.float32)
        got_v = float(cloud_var(live, np.int32(nlive), tpack))
        w = live[:nlive].astype(np.float64) @ T
        ref_v = float(((w - w.mean(axis=0)) ** 2).sum() / nlive)
        err_var = abs(got_v - ref_v) / ref_v
        worst = max(worst, err_jump, err_var)
        report('kernel.whitening', d=d, rows=popsize,
               jump2_max_rel_err=err_jump, cloud_var_rel_err=err_var,
               tolerance=DOT_RTOL)
    check(worst < DOT_RTOL, 'whitening dots exceed rtol %g' % DOT_RTOL)


def timed_twice(fn):
    """Run *fn* twice; return (first row, second row) — the second warm."""
    first = fn()
    return first, fn()


def phase_eggbox():
    import bench
    expected = bench.eggbox_logz_expected()
    cold, row = timed_twice(lambda: bench.run_eggbox(True, seed=42))
    ok = abs(row['logz'] - expected) < max(4 * row['logzerr'], 1.0)
    report('eggbox', wall_s=row['wall_s'], cold_wall_s=cold['wall_s'],
           ncall=row['ncall'], logz=row['logz'], logzerr=row['logzerr'],
           logz_expected=expected, logz_ok=ok,
           phases=row.get('phases'))
    check(ok, 'eggbox logZ gate failed')


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get('peak_bytes_in_use')


def phase_asymgauss(rehearse):
    import bench
    if rehearse:
        from ultranest_tpu import models
        cold, row = timed_twice(lambda: bench._run_popfused(
            models.asymgauss(ndim=8, sigma_min=0.01), 1, popsize=256,
            nsteps=16))
    else:
        cold, row = timed_twice(lambda: bench.run_asymgauss50(seed=1))
    ok = abs(row['logz']) < max(4 * row['logzerr'], 1.5)
    report('asymgauss50', wall_s=row['wall_s'], cold_wall_s=cold['wall_s'],
           ncall=row['ncall'], ncall_useful=row.get('ncall_useful'),
           logz=row['logz'], logzerr=row['logzerr'], logz_ok=ok,
           phases=row.get('phases'), peak_bytes_in_use=_peak_bytes())
    check(ok, 'asymgauss50 logZ gate failed')


def phase_gauss100(rehearse):
    import bench
    from ultranest_tpu import models
    ndim = 10 if rehearse else 100
    row = bench._run_popfused(models.gauss(ndim=ndim, sigma=0.1), 3,
                              popsize=256 if rehearse else 2048,
                              nsteps=100, adaptive_nsteps=True)
    ok = abs(row['logz']) < max(4 * row['logzerr'], 2.0)
    report('gauss100', ndim=ndim, cold_wall_s=row['wall_s'],
           ncall=row['ncall'], ncall_useful=row.get('ncall_useful'),
           logz=row['logz'], logzerr=row['logzerr'], logz_ok=ok,
           nsteps_final=row.get('nsteps_final'), phases=row.get('phases'),
           peak_bytes_in_use=_peak_bytes())
    check(ok, 'gauss100 logZ gate failed')


def run_one(rehearse):
    events = cache_event_counter()
    t0 = time.perf_counter()
    phase_device()
    if rehearse:
        # the CPU backend keeps the rejection segment engine off by
        # default; the rehearsal drives it as the GPU does
        os.environ['ULTRANEST_TPU_SEGMENT_REJECTION'] = '1'
        check_membership([(64, 50, 512, 2), (64, 50, 512, 50)])
        check_whitening([50])
    else:
        check_membership([(512, 400, m, d) for d in (2, 50)
                          for m in (4096, 32768)])
        check_whitening([50, 100])
    phase_eggbox()
    phase_asymgauss(rehearse)
    phase_gauss100(rehearse)
    report('compile_cache', **dict(events),
           total_wall_s=time.perf_counter() - t0)


def _device_peaks():
    import jax
    return [(d.memory_stats() or {}).get('peak_bytes_in_use', 0)
            for d in jax.devices()]


def run_four(ndev, rehearse):
    """The mesh path on *ndev* devices, each part against one device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from __graft_entry__ import check_sharded_rejection
    from ultranest_tpu import models
    from ultranest_tpu.ops.bootstrap import (_radius_kernel,
                                             _radius_kernel_sharded,
                                             make_bootstrap_masks)
    from ultranest_tpu.ops.pairwise import pad_rows
    from ultranest_tpu.parallel import make_mesh

    phase_device()
    mesh = make_mesh(ndev)
    mesh_ids = sorted(d.id for d in mesh.devices.flat)

    # (a) sharded fused rejection run: exact ncall bookkeeping,
    # determinism per mesh, statistical agreement with one device
    kw = dict(nlive=50, ndraw_min=256, ndraw_max=1024) if rehearse \
        else dict(nlive=400, ndraw_min=4096, ndraw_max=32768)
    out = check_sharded_rejection(mesh, **kw)
    report('mesh.rejection', **kw, **out)

    # (b) sharded population sampler: ndev devices against one
    if rehearse:
        prob = models.asymgauss(ndim=8, sigma_min=0.01)
        pop = dict(popsize=64 * ndev, nsteps=16)
    else:
        prob = models.asymgauss(ndim=50, sigma_min=0.01)
        pop = dict(popsize=4096, nsteps=100)
    seen = set()
    from ultranest_tpu.popfused import FusedPopulationSliceSampler
    launch = FusedPopulationSliceSampler.segment_launch

    def spy_launch(self, region, tregion=None):
        launch(self, region, tregion=tregion)
        seen.update(d.id for d in self._seg_state[0].sharding.device_set)

    FusedPopulationSliceSampler.segment_launch = spy_launch
    try:
        rows = {}
        for name, m in (('mesh', mesh), ('one', None)):
            seen.clear()
            bench._run_popfused(prob, 1, mesh=m, **pop)          # warm
            rows[name] = bench._run_popfused(prob, 1, mesh=m, **pop)
            rows[name]['devices'] = sorted(seen)
    finally:
        FusedPopulationSliceSampler.segment_launch = launch
    a, b = rows['mesh'], rows['one']
    sigma = float(np.hypot(a['logzerr'], b['logzerr']))
    gate = {k: abs(r['logz']) < max(4 * r['logzerr'], 1.5)
            for k, r in rows.items()}
    agree = abs(a['logz'] - b['logz']) < 4 * sigma
    fields = {'%s_%s' % (k, f): r[f] for k, r in rows.items()
              for f in ('wall_s', 'logz', 'logzerr', 'ncall', 'devices')}
    report('mesh.population', ndim=8 if rehearse else 50, **pop, **fields,
           logz_agree_4sigma=agree, logz_ok=gate)
    check(rows['mesh']['devices'] == mesh_ids,
          'population outputs on %s' % rows['mesh']['devices'])
    check(agree and all(gate.values()), 'sharded population run failed')

    # (c) sharded bootstrap radius against the single-device kernel
    n = 256 if rehearse else 2048
    rng = np.random.default_rng(13)
    tp = rng.normal(size=(n, 8)).astype(np.float32)
    masks = make_bootstrap_masks(n, 8 * ndev, rng=np.random.RandomState(4))
    nrounds = -(-len(masks) // ndev) * ndev
    mk = np.ones((nrounds, n), dtype=bool)
    mk[:len(masks)] = masks
    valid = pad_rows(np.ones(n, bool), n, False)
    mk_sharded = jax.device_put(mk, NamedSharding(mesh, P('ranks')))
    shard_devs = sorted(s.device.id for s in mk_sharded.addressable_shards)
    got = float(_radius_kernel_sharded(mesh)(tp, valid, mk_sharded))
    ref = float(_radius_kernel(tp, valid, mk))
    report('mesh.bootstrap_radius', N=n, rounds=nrounds, sharded=got,
           single=ref, bit_identical=got == ref, mask_shards_on=shard_devs,
           tolerance='rel 1e-6 (two compiled programs may contract the '
           'distance sums differently)')
    check(shard_devs == mesh_ids, 'mask shards on %s' % shard_devs)
    check(abs(got - ref) <= 1e-6 * abs(ref),
          'sharded radius %r vs %r' % (got, ref))
    report('mesh.device_peaks', peak_bytes_in_use=_device_peaks())


def main(argv):
    rehearse = '--rehearse' in argv
    chips = int(argv[argv.index('--chips') + 1]) if '--chips' in argv \
        else 1
    if rehearse:
        import jax
        devices = jax.devices()
    else:
        devices = require_gpu(chips)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if chips > 1:
        run_four(chips, rehearse)
    else:
        run_one(rehearse)
    if rehearse:
        print('rehearsal passed (no result line: not a GPU run)')
        return
    import bench
    print('gpu: %s' % bench.nvidia_smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}))


if __name__ == '__main__':
    main(sys.argv[1:])
