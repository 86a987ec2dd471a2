"""Multi-process launcher: 2 spawned controllers, one global mesh.

Drives the real shard_map kernels (bootstrap radius, fused proposal)
over a mesh spanning two OS processes connected through
``jax.distributed`` + gloo — the JAX equivalent of the
reference's MPI deployment (integrator.py:1148-1159). Each subprocess
compares its multi-process result against the locally computed
single-process value.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_CHILD = r'''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
os.environ['ULTRANEST_TPU_COORDINATOR'] = 'localhost:%s' % port
os.environ['ULTRANEST_TPU_NPROC'] = '2'
os.environ['ULTRANEST_TPU_PROCID'] = str(pid)
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
import jax
jax.config.update('jax_platforms', 'cpu')
from ultranest_tpu.parallel import launch
launch.init_distributed()
assert jax.process_count() == 2, jax.process_count()
mesh = launch.global_mesh()
assert mesh.devices.size == 4, mesh
assert launch.is_multiprocess_mesh(mesh)

import numpy as np

# 1) sharded bootstrap radius over the global mesh == host reference
from ultranest_tpu.ops import bootstrap
rng = np.random.RandomState(42)         # same stream in both processes
tpoints = rng.normal(size=(64, 3)).astype(np.float32)
masks = bootstrap.make_bootstrap_masks(64, 8, rng=rng)
maxd, enl, ok = bootstrap.bootstrap_radius_enlargement(
    tpoints, tpoints, masks, mode='mlfriends', mesh=mesh)
assert ok
from ultranest_tpu.ops.pairwise import _np_sqdist
d2 = _np_sqdist(tpoints, tpoints)
best = max(float(d2[sel][:, ~sel].min(axis=0).max()) for sel in masks)
assert abs(maxd - best) < 1e-3 * max(best, 1.0), (maxd, best)

# 2) fused proposal kernel sharded over the global mesh
from ultranest_tpu.fused import FusedRegionSampler
from ultranest_tpu.mlfriends import AffineLayer, MLFriends
import jax.numpy as jnp

def jll(v):
    return -0.5 * jnp.sum(((v - 0.5) / 0.1) ** 2, axis=1)

us = np.clip(rng.normal(0.5, 0.1, size=(100, 3)), 0.01, 0.99)
layer = AffineLayer()
layer.optimize(us, us)
region = MLFriends(us, layer)
region.maxradiussq, region.enlarge = region.compute_enlargement(
    nbootstraps=5, rng=np.random.RandomState(1))
region.create_ellipsoid()
fs = FusedRegionSampler(jll, None, 3, seed=7, mesh=mesh)
u, v, logl, nc, ndrawn = fs(region, -100.0, 512)
assert len(u) > 0
assert nc > 0
assert (logl > -100.0).all()
np.testing.assert_array_less(0, u)
np.testing.assert_array_less(u, 1)

# 3) segment kernel over the multi-process mesh: walk sharded across
# controllers, consume replicated -- live state must stay identical
# on every process (the every-rank-holds-the-live-set invariant)
from ultranest_tpu.popfused import FusedPopulationSliceSampler
ss = FusedPopulationSliceSampler(popsize=8, nsteps=4, jax_loglike=jll,
                                 seed=3, engine='spec', mesh=mesh)
lus = np.clip(rng.normal(0.5, 0.1, size=(32, 3)), 0.01, 0.99)
lLs = np.asarray(jll(jnp.asarray(lus)))
ss.segment_start(lus.astype(np.float32), lLs.astype(np.float32))
ss.segment_launch(region)
rec = ss.segment_fetch()
ss.segment_stop()
assert rec['nc'] > 0
assert rec['accept'].any()
import hashlib
seg_digest = hashlib.md5(np.round(rec['L'], 5).tobytes()).hexdigest()

# 4) strategy reduction identity: every controller computes the same
# decision table from replicated host data (the stated §2.4 design —
# see parallel/strategy.py docstring)
from ultranest_tpu.parallel.strategy import bootstrap_kl_table
rng2 = np.random.RandomState(5)
ref_w = np.log(rng2.dirichlet(np.ones(200))).reshape((-1, 1))
other_w = np.log(rng2.dirichlet(np.ones(200), size=8)).T
KL, KLtot = bootstrap_kl_table(ref_w, other_w, mesh=mesh)
import hashlib
digest = hashlib.md5(np.round(KL, 8).tobytes()
                     + np.round(KLtot, 6).tobytes()).hexdigest()
print('DIST_OK', pid, len(u), nc, digest + seg_digest, flush=True)
'''


# Full ReactiveNestedSampler.run() on every controller — the analogue
# of the reference's release gate `mpiexec -np 5 python -m pytest`
# (/root/reference/Makefile:103-107): the ENTIRE driver executes on
# every rank (reference integrator.py:1148-1159) and all ranks must
# finish with identical results. Here: 2 gloo-connected controllers,
# one global mesh from launch.global_mesh(), (a) the fused rejection
# path and (b) the sharded segment step-sampler path, both to
# completion, digests compared across controllers.
_CHILD_FULLRUN = r'''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
nproc = int(sys.argv[3])
ndev = int(sys.argv[4])
use_slice_mesh = len(sys.argv) > 5 and sys.argv[5] == 'slice'
os.environ['ULTRANEST_TPU_COORDINATOR'] = 'localhost:%s' % port
os.environ['ULTRANEST_TPU_NPROC'] = str(nproc)
os.environ['ULTRANEST_TPU_PROCID'] = str(pid)
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = \
    '--xla_force_host_platform_device_count=%d' % ndev
import jax
jax.config.update('jax_platforms', 'cpu')
from ultranest_tpu.parallel import launch
launch.init_distributed()
assert jax.process_count() == nproc, jax.process_count()
if use_slice_mesh:
    # 2-axis (hosts, ranks) mesh: process groups x devices-per-process
    mesh = launch.slice_mesh()
    assert mesh.devices.shape == (nproc, ndev), mesh
else:
    mesh = launch.global_mesh()
assert launch.is_multiprocess_mesh(mesh)

import numpy as np
import jax.numpy as jnp
from ultranest_tpu import ReactiveNestedSampler

def ll(t):
    return -0.5 * (((t - 0.5) / 0.1) ** 2).sum(axis=1)

# (a) fused rejection path, candidate generation sharded across the
# controllers, full driver loop on each
s = ReactiveNestedSampler(['a', 'b'], ll, transform=None,
                          vectorized=True, seed=42, jax_loglike=ll,
                          mesh=mesh)
r = s.run(min_num_live_points=100, show_status=False, viz_callback=False,
          max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
          frac_remain=0.1)
assert abs(r['logz'] + 2.77) < 1.0, r['logz']

# (b) device population slice sampler: walk sharded over the mesh,
# consume replicated (segment path), full driver loop on each
from ultranest_tpu.popfused import FusedPopulationSliceSampler
s2 = ReactiveNestedSampler(['a', 'b'], ll, transform=None,
                           vectorized=True, seed=7)
s2.stepsampler = FusedPopulationSliceSampler(
    popsize=16, nsteps=6, jax_loglike=ll, seed=5, engine='spec',
    mesh=mesh)
r2 = s2.run(min_num_live_points=50, show_status=False, viz_callback=False,
            max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
            frac_remain=0.1)
assert abs(r2['logz'] + 2.77) < 1.5, r2['logz']

print('FULLRUN_OK', pid,
      '%.6f' % r['logz'], r['ncall'], r['niter'],
      '%.6f' % r2['logz'], r2['ncall'], r2['niter'], flush=True)
'''


def _run_controllers(tmp_path, source, port, marker, nproc=2,
                     extra_args=(), timeout=300):
    """Spawn *nproc* gloo-connected controllers; return marker lines."""
    script = tmp_path / 'child.py'
    script.write_text(source)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_PLATFORMS', 'XLA_FLAGS')}
    env['PYTHONPATH'] = repo + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), port]
        + [str(a) for a in extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=repo)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (pid, out[-3000:])
        line = [ln for ln in out.splitlines() if ln.startswith(marker)]
        assert line, (pid, out[-3000:])
        results.append(line[0].split())
    return results


@pytest.mark.slow
def test_two_process_mesh_kernels(tmp_path):
    results = _run_controllers(tmp_path, _CHILD, '9923', 'DIST_OK')
    # both controllers saw the identical gathered result
    assert results[0][2:] == results[1][2:], results


@pytest.mark.slow
def test_two_process_full_run(tmp_path):
    """ReactiveNestedSampler.run() completes on both controllers with
    identical logz/ncall/niter digests (both engine families)."""
    results = _run_controllers(tmp_path, _CHILD_FULLRUN, '9931',
                               'FULLRUN_OK', nproc=2, extra_args=(2, 2),
                               timeout=600)
    assert results[0][2:] == results[1][2:], results


@pytest.mark.slow
def test_four_process_full_run(tmp_path):
    """np=4 analogue of the reference's `mpiexec -np 5` release gate
    (/root/reference/Makefile:103-107): four gloo controllers, one
    device each, full runs with identical digests on every rank.

    np=4 exercises gather/truncate edge cases np=2 cannot: the
    region's nbootstraps=30 does not divide evenly over 4 shards, and
    popsize-16 walks split into 4-walker shards.
    """
    results = _run_controllers(tmp_path, _CHILD_FULLRUN, '9941',
                               'FULLRUN_OK', nproc=4, extra_args=(4, 1),
                               timeout=900)
    for other in results[1:]:
        assert results[0][2:] == other[2:], results


@pytest.mark.slow
def test_slice_mesh_full_run(tmp_path):
    """Full reactive run on the 2-axis (hosts, ranks) slice_mesh spanning
    2 process groups x 2 devices: collectives take the axis tuple, the
    outer axis crosses the process boundary (the network between hosts)."""
    results = _run_controllers(tmp_path, _CHILD_FULLRUN, '9951',
                               'FULLRUN_OK', nproc=2,
                               extra_args=(2, 2, 'slice'), timeout=900)
    assert results[0][2:] == results[1][2:], results
