"""A/B the speculative nsteps-kernel prewarm on the cold 100-d anchor.

The adaptive governor's doublings (100 -> 200 -> 400 on the sigma=0.01
gaussian) each invalidate the segment kernel; on a cold compile cache
the next dispatch blocks in XLA, billed to the 'launch' phase. The
prewarm thread builds the doubled kernel while the run proceeds, so
growth events should find a warm executable.

Each arm runs in THIS process with a fresh JAX_COMPILATION_CACHE_DIR,
so run one arm per process:

    python evaluate/prewarm_ab.py on
    python evaluate/prewarm_ab.py off

and compare the printed phase tables (esp. 'launch').
"""
import json
import os
import sys
import tempfile

arm = sys.argv[1] if len(sys.argv) > 1 else 'on'
cache = tempfile.mkdtemp(prefix='prewarm-ab-%s-' % arm)
os.environ['JAX_COMPILATION_CACHE_DIR'] = cache

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from bench import _run_popfused  # noqa: E402

from ultranest_tpu import models  # noqa: E402
from ultranest_tpu.popfused import FusedPopulationSliceSampler  # noqa: E402

if arm == 'off':
    FusedPopulationSliceSampler._prewarm_next_nsteps = \
        lambda self, args: None

prob = models.gauss(ndim=100, sigma=0.01)
row = _run_popfused(prob, seed=3, popsize=2048, nsteps=100,
                    adaptive_nsteps=True)
row['arm'] = arm
row['cache_dir'] = cache
print(json.dumps(row))
