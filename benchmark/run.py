"""Run one cell of the benchmark of ``emdr2_tpu_torch`` on the card.

    python3 benchmark/run.py --workload C --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the numbers compared against the plain
reference, each beside its limit, as the last lines of standard error, and
one JSON result line as the last line of standard output. Exits non-zero,
with no result line, without a CUDA card or with fewer cards than the cell
asks for. ``BENCHMARK.json`` at the root names the cells.
"""

import sys
import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import main
    sys.exit(main(started=STARTED))
