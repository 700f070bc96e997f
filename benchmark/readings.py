"""The readings that the limits of a cell's comparison are set from: for
each seed, the program's numbers against the plain reference (the lower
reading), the reference's own numbers in fp8 (the control, the precision
below the configurations' bf16) and those of planted faults (the upper
reading). Each driver's `readings` says what it plants. One process takes
every seed, so the kernels build once.

    python3 benchmark/readings.py --workload NAME --seeds 1,2,3 [--detail] [--out FILE]

--detail adds what a look at a reading needs: per leaf of a train cell, the
gradient's norms; for a render cell, the port's plain PyTorch path against
the reference beside its kernels. Prints one JSON line per seed; the card is
required, as for run.py.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--detail", action="store_true")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    a = p.parse_args(argv)
    from benchmark import harness
    import torch

    cell = harness.load_cell(a.workload)
    harness.check_card(1)
    device = torch.device("cuda:0")
    drv = harness.driver(cell.traffic)
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        res = {"workload": a.workload, "seed": int(s),
               **drv.readings(cell, int(s), device, detail=a.detail),
               "seconds": time.perf_counter() - t0}
        line = json.dumps(res)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
