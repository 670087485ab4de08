#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port (``nbody_tpu_torch``) on one
NVIDIA H100: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload disc-100k.headless --seed 7 --seconds 50 \
        --trace 0

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each compared number beside its limit),
and the compared numbers as the last lines of standard error.  Exits
non-zero without a result when there are fewer CUDA cards than the cell
asks for, when the program is not in this checkout, or when JAX or the JAX
package got loaded.

A cell with ``"chips": 4`` needs no launcher: this process becomes rank 0
and starts three more of itself, one a card, which join one NCCL group;
each builds the system on its card and makes the same calls, rank 0 ends
the window for all, gathers the whole state for the check and alone prints
the result.  A rank that fails or dies ends the run without a result
within ``harness/ranks.py``'s ``FAIL_BOUND_S`` (``harness/main.py``).
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.run(sys.argv[1:], T_START))
