"""Runs one cell of the port's benchmark once and prints its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Needs as many CUDA cards as the cell asks
for; without them it exits non-zero and prints no result. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared with its limit); the same numbers
close standard error.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from h100bench import harness

    harness.set_cache_dirs()
    import torch

    bench = harness.spec()
    chips = harness.workload(args.workload, bench)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              STARTED, bench=bench)
    card = harness.card_line()
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    print(f"card: {card}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
