"""Platform plumbing: compile cache, the smoke script's device check,
host-grouped meshes and one GPU per process.

The GPU-marked test at the end runs only where JAX finds a GPU
(``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``); it decides
inside a fixture, so every worker collects the same tests.
"""
import importlib
import os
import sys

import pytest

import jax

import ultranest_tpu
from ultranest_tpu.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeConfig:
    """Stands in for jax.config: records updates, touches nothing."""

    def __init__(self, cache_dir=None):
        self.jax_compilation_cache_dir = cache_dir
        self.updates = {}

    def update(self, name, value):
        self.updates[name] = value
        setattr(self, name, value)


def test_compile_cache_env_var_wins():
    cfg = _FakeConfig(cache_dir='/somewhere/else')
    ultranest_tpu._enable_persistent_compile_cache(
        cfg, {'JAX_COMPILATION_CACHE_DIR': '/somewhere/else'})
    assert 'jax_compilation_cache_dir' not in cfg.updates
    assert cfg.jax_compilation_cache_dir == '/somewhere/else'


def test_compile_cache_default_is_checkout():
    cfg = _FakeConfig()
    ultranest_tpu._enable_persistent_compile_cache(cfg, {})
    assert cfg.updates['jax_compilation_cache_dir'] == \
        os.path.join(ROOT, '.jax_cache')
    assert ultranest_tpu.DEFAULT_COMPILE_CACHE == \
        os.path.join(ROOT, '.jax_cache')


def test_compile_cache_none_when_pinned_to_cpu():
    cfg = _FakeConfig()
    ultranest_tpu._enable_persistent_compile_cache(
        cfg, {'JAX_PLATFORMS': 'cpu'})
    assert cfg.updates == {}


def _from_root(name):
    """Import a script at the repository root as a module."""
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(ROOT)


def test_bench_does_not_override_compile_cache():
    before = jax.config.jax_compilation_cache_dir
    _from_root('bench').device_record()
    assert jax.config.jax_compilation_cache_dir == before
    with open(os.path.join(ROOT, 'bench.py')) as f:
        assert 'compilation_cache' not in f.read()


def test_bench_fails_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', ['bench.py'])
    with pytest.raises(SystemExit) as e:
        _from_root('bench').main()
    assert 'GPU' in str(e.value.code)
    assert capsys.readouterr().out == ''


def test_chip_smoke_requires_gpu():
    with pytest.raises(RuntimeError, match='needs a GPU'):
        _from_root('chip_smoke').require_gpu()


def test_chip_smoke_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(RuntimeError):
        _from_root('chip_smoke').main([])
    assert '"ok"' not in capsys.readouterr().out


class _Dev:
    def __init__(self, i, process_index):
        self.id = i
        self.process_index = process_index

    def __repr__(self):
        return 'Dev(%d, p%d)' % (self.id, self.process_index)


def test_slice_mesh_groups_by_process(monkeypatch):
    # two processes with four devices each, listed interleaved
    devs = [_Dev(i, i % 2) for i in range(8)]
    monkeypatch.setattr(jax, 'devices', lambda: devs)
    mesh = launch.slice_mesh()
    assert mesh.axis_names == ('hosts', 'ranks')
    assert mesh.devices.shape == (2, 4)
    for row, pid in zip(mesh.devices, (0, 1)):
        assert {d.process_index for d in row} == {pid}


def test_slice_mesh_uneven_groups_fall_back_flat(monkeypatch):
    devs = [_Dev(i, 0 if i < 3 else 1) for i in range(8)]
    monkeypatch.setattr(jax, 'devices', lambda: devs)
    assert launch.slice_mesh().devices.shape == (1, 8)


@pytest.mark.parametrize('coordinator, env, kwargs, expected', [
    ('localhost:9911', {}, {}, [1]),
    ('127.0.0.1:9911', {}, {}, [1]),
    ('host0:9911', {'OMPI_COMM_WORLD_LOCAL_RANK': '3'}, {}, [3]),
    ('host0:9911', {}, {}, None),
    ('localhost:9911', {}, {'local_device_ids': [0, 1]}, [0, 1]),
])
def test_init_distributed_one_gpu_per_process(monkeypatch, coordinator, env,
                                              kwargs, expected):
    for var in launch._LOCAL_RANK_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    seen = {}
    monkeypatch.setattr(jax.distributed, 'initialize',
                        lambda **kw: seen.update(kw))
    launch.init_distributed(coordinator, 2, 1, **kwargs)
    assert seen['coordinator_address'] == coordinator
    assert seen['num_processes'] == 2 and seen['process_id'] == 1
    assert seen.get('local_device_ids') == expected


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)')


@pytest.mark.gpu
def test_kernels_match_float64_on_gpu(gpu):
    """Phase 1 of chip_smoke.py: membership and whitening dots at real
    widths against float64, compiled for the card."""
    smoke = _from_root('chip_smoke')
    smoke.check_membership([(512, 400, 4096, d) for d in (2, 50)])
    smoke.check_whitening([50, 100])
