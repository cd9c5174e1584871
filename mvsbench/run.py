"""The benchmark's one command: one run of one cell, one JSON line.

    python3 mvsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cell's CUDA
devices, and fails (no result line) without them.  With ``--trace 0`` the
line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones (see ``harness.py``).  The numbers compared with the reference, each
beside its limit, are the last lines on standard error and the last key
(``checks``) of the line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card_record() -> str:
    """The card's name and power limit, for the log beside the numbers."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from mvsbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload, bool(args.trace))
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"[mvsbench] {args.workload} needs {need} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    run, checks = harness.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), T_START)
    line = harness.result_line(run, checks, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"[mvsbench] the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"[mvsbench] card: {card_record()}", file=sys.stderr)
    for name, value, limit, ok in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
