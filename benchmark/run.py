"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the chips the cell
asks for.  The last line of standard output is one JSON object (see
``benchmark/README.md``); the numbers that decided ``correct`` are the
last lines of standard error.  Exits non-zero, printing no result,
without CUDA or enough cards, when the port cannot be imported, or when
JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

if __name__ == "__main__":
    from perfkit.runner import main
    sys.exit(main(sys.argv[1:], T_PROCESS))
