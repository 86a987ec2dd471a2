"""Profile the asymgauss-50d headline run (warm) with cProfile.

Runs the headline config once to absorb compiles, then profiles a second
run. Prints the top cumulative and tottime entries plus the segment
phase breakdown, so host-side optimization targets are measured, not
guessed (docs/performance.md "phase profile").
"""
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import jax  # noqa: E402

use_jax = jax.default_backend() != 'cpu'
print('backend:', jax.default_backend())

bench.run_asymgauss50(use_jax)          # warm-up: compiles + program load

pr = cProfile.Profile()
t0 = time.time()
pr.enable()
row = bench.run_asymgauss50(use_jax)
pr.disable()
print('warm wall: %.3f s' % (time.time() - t0))
print('row:', {k: v for k, v in row.items() if k != 'phases'})
print('phases:', row.get('phases'))

for sort in ('cumulative', 'tottime'):
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats(sort)
    ps.print_stats(25)
    print('==== sorted by', sort, '====')
    print(s.getvalue())
