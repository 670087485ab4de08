#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port (``nbody_tpu_torch``) on one
NVIDIA H100: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload disc-100k.batch --seed 7 --seconds 50 \
        --trace 0

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each compared number beside its limit),
and the compared numbers as the last lines of standard error.  Exits
non-zero without a result when there is no CUDA card, when the program is
not in this checkout, or when JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.run(sys.argv[1:], T_START))
