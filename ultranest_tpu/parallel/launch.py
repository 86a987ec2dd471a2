# noqa: D400 D205
"""
Multi-process / multi-host launcher
-----------------------------------

The reference runs on any MPI cluster with zero code changes (MPI
detection at `/root/reference/ultranest/integrator.py:1148-1159`). The
JAX equivalent is the multi-controller runtime: every process calls
:func:`init_distributed` once, after which ``jax.devices()`` spans the
whole job (several GPUs and hosts, or N CPU processes connected via
gloo) and one :class:`jax.sharding.Mesh` over those devices drives the
same ``shard_map`` paths used single-process.

One process can drive every GPU of its host (``make_mesh`` over
``jax.devices()``); a multi-process job is needed only across hosts, or
when each GPU gets its own process. Typical launches::

    # every process of a job runs
    import ultranest_tpu.parallel.launch as launch
    launch.init_distributed()
    mesh = launch.global_mesh()
    sampler = ReactiveNestedSampler(..., mesh=mesh)

    # 2 processes: give each its address, count and rank
    #   ULTRANEST_TPU_COORDINATOR=host0:9911 ULTRANEST_TPU_NPROC=2 \\
    #   ULTRANEST_TPU_PROCID=0 python run.py   (and PROCID=1 on host1)

    # mpiexec-style launchers: OMPI_COMM_WORLD_{SIZE,RANK} are honored,
    #   so `mpiexec -n 4 python run.py` works with just a coordinator
    #   address.

Data placement: in a multi-controller job, every process must construct
*global* device arrays for sharded inputs; :func:`put_along_mesh` builds
them from the identical host array each controller already holds (the
single-controller code paths pass numpy directly and jax places it,
which is only valid when all mesh devices are addressable).
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ['init_distributed', 'global_mesh', 'slice_mesh',
           'put_along_mesh', 'is_multiprocess_mesh', 'fetch_replicated']


def fetch_replicated(x):
    """Host copy of a replicated device array.

    Multi-controller outputs span non-addressable devices; every
    process reads its own (identical) local replica instead of the
    global array. Single-controller arrays and numpy pass through.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return np.asarray(x.addressable_data(0))
    return np.asarray(jax.device_get(x))


_LOCAL_RANK_VARS = ('OMPI_COMM_WORLD_LOCAL_RANK', 'MPI_LOCALRANKID',
                    'SLURM_LOCALID')
_LOCAL_HOSTS = ('localhost', '127.0.0.1', '[::1]', '::1')


def _local_rank(coordinator_address, process_id):
    """This process's rank among the processes of its host, or None.

    Taken from the launcher's environment where it says so; otherwise a
    coordinator on ``localhost`` means every process runs on this host,
    so the global rank is the local rank.
    """
    for var in _LOCAL_RANK_VARS:
        if os.environ.get(var, '') != '':
            return int(os.environ[var])
    if coordinator_address is not None and process_id is not None:
        host = coordinator_address.rsplit(':', 1)[0]
        if host in _LOCAL_HOSTS:
            return int(process_id)
    return None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Connect this process to the jax multi-controller runtime.

    Argument resolution order:

    1. explicit arguments;
    2. ``ULTRANEST_TPU_COORDINATOR`` / ``ULTRANEST_TPU_NPROC`` /
       ``ULTRANEST_TPU_PROCID`` environment variables;
    3. MPI launcher environment (``OMPI_COMM_WORLD_SIZE/RANK``,
       ``PMI_SIZE/RANK``) for the process count/rank — the reference's
       `mpiexec` deployment style;
    4. whatever ``jax.distributed.initialize()`` detects itself (Slurm,
       Open MPI); without a cluster environment it needs all three.

    Each process is given one GPU of its host (``local_device_ids`` =
    its local rank, see :func:`_local_rank`) unless the caller passes
    ``local_device_ids``: a JAX process reserves most of the memory of
    every GPU it sees, so processes sharing a host must not see each
    other's cards. Other platforms ignore the setting.

    Safe to call when already initialized (no-op).
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get('ULTRANEST_TPU_COORDINATOR')
    if num_processes is None:
        for var in ('ULTRANEST_TPU_NPROC', 'OMPI_COMM_WORLD_SIZE',
                    'PMI_SIZE'):
            if env.get(var):
                num_processes = int(env[var])
                break
    if process_id is None:
        for var in ('ULTRANEST_TPU_PROCID', 'OMPI_COMM_WORLD_RANK',
                    'PMI_RANK'):
            if env.get(var) is not None and env.get(var) != '':
                process_id = int(env[var])
                break
    if 'local_device_ids' not in kwargs:
        local = _local_rank(coordinator_address, process_id)
        if local is not None:
            kwargs['local_device_ids'] = [local]
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    except RuntimeError as e:
        if 'already initialized' not in str(e):
            raise


def global_mesh(axis_name='ranks'):
    """A 1-axis mesh over every device of the (distributed) job."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def slice_mesh(axis_names=('hosts', 'ranks')):
    """A 2-axis mesh: owning processes x devices per process.

    Devices are grouped by the process that drives them. GPUs within a
    host are joined all to all by NVLink and hosts by the network, so
    the outer axis crosses the slower link. The engines shard work over
    BOTH axes (every device is a worker) and XLA decomposes the
    tuple-axis collectives hierarchically, so only the already-reduced
    per-host results cross the network. The reference has no
    multi-machine topology awareness at all (flat MPI ranks,
    reference ultranest/integrator.py:1148-1159). Falls back to a
    1 x N mesh when the job has a single process or uneven groups.
    """
    devices = jax.devices()
    groups = {}
    for d in devices:
        groups.setdefault(d.process_index, []).append(d)
    sizes = {len(v) for v in groups.values()}
    if len(groups) <= 1 or len(sizes) != 1:
        arr = np.array(devices).reshape(1, len(devices))
    else:
        arr = np.array([groups[k] for k in sorted(groups)])
    return Mesh(arr, tuple(axis_names))


def is_multiprocess_mesh(mesh):
    """Whether *mesh* contains devices owned by other processes."""
    if mesh is None:
        return False
    pid = jax.process_index()
    return any(d.process_index != pid for d in mesh.devices.flat)


def put_along_mesh(mesh, spec, x):
    """Build a global device array for *x* on *mesh* with PartitionSpec
    *spec*, from the identical full host copy every controller holds.

    This is how the single-controller idiom "pass the same numpy array
    everywhere" carries over to multi-controller jobs: each process
    supplies the shards it owns, sliced from its local copy.
    """
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def put_args(mesh, specs, args):
    """``put_along_mesh`` over a (spec, arg) sequence."""
    return tuple(put_along_mesh(mesh, s, a) for s, a in zip(specs, args))
