"""Runs one benchmark cell once and prints its result as the last line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/README.md``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None):
    parser = argparse.ArgumentParser(description="run one portbench cell once")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(parse(), T0))
