"""Readings of the comparison that decides ``correct``, on the card: the
cell run as the benchmark runs it, sound or with a fault of ``faults.py``
planted under the timed path, over several seeds in one process; one JSON
line per seed with every number the reference computes.

    python3 mvsbench/control.py --workload <cell> --seconds <s> \
        --fault {none,fp8_taps,no_op,half_left_out,answer_altered} \
        --seeds <n> [<n> ...]

``fp8_taps`` is the control: its readings set the upper end of each limit
(``limits/<cell>.json``); the sound runs' set the lower end.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    import torch

    from mvsbench import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="none",
                    choices=["none", *faults.FAULTS])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        cell = harness.find_cell(bench, args.workload, False)
        plant = (contextlib.nullcontext() if args.fault == "none"
                 else faults.FAULTS[args.fault]())
        with plant:
            run, checks = harness.run_cell(cell, seed, args.seconds, False,
                                           time.perf_counter())
        line = harness.result_line(run, checks, False)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": line["correct"],
                          "calls": len(run.calls), "numbers": run.numbers,
                          "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
