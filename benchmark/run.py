"""The benchmark of diffquantum_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Run from the checkout's root, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, with its limit). Without a card, or without the program beside
the benchmark, it exits non-zero and prints no result.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))   # the checkout's root

from harness import runner  # noqa: E402

if __name__ == "__main__":
    try:
        sys.exit(runner.main())
    except runner.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        sys.exit(2)
