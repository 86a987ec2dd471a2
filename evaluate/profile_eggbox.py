"""Profile the eggbox headline on the default backend.

Runs bench.run_eggbox once to warm jit caches, then again under
cProfile; dumps stats to bench_out/eggbox.prof for offline analysis.
"""
import cProfile
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402
import jax  # noqa: E402

use_jax = jax.default_backend() != 'cpu'
print('backend:', jax.default_backend())

row = bench.run_eggbox(use_jax, seed=7)
print('warm run:', row)
row = bench.run_eggbox(use_jax, seed=42)
print('warm run 2:', row)

prof = cProfile.Profile()
prof.enable()
row = bench.run_eggbox(use_jax, seed=42)
prof.disable()
print('profiled run:', row)
os.makedirs(os.path.join(ROOT, 'bench_out'), exist_ok=True)
prof.dump_stats(os.path.join(ROOT, 'bench_out', 'eggbox.prof'))
stats = pstats.Stats(prof)
stats.sort_stats('cumulative').print_stats(25)
