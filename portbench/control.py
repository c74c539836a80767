"""The control: one cell run with a fault planted in the port
(``portbench.faults``; by default ``no_verify``, the configuration's
integrity guarantee broken). Its result must read ``"correct": false``.

    python3 -m portbench.control --workload <cell> --seed <n> --seconds <s> [--fault <name>]
"""

from __future__ import annotations

import argparse
import sys

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--fault", default="no_verify")
    args, rest = p.parse_known_args(argv)
    return run.main(rest, fault=args.fault)


if __name__ == "__main__":
    sys.exit(main())
