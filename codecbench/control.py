"""The control of `correct`: a cell's whole run, but with the reference
computed in bfloat16 (the nearest precision below the configuration's
float32) put in the program's place for the checked streams. It has to
come out as not correct; its readings set the upper end of each limit.

    python -m codecbench.control --workload <cell> --seconds <s> --seeds <n>,<n>,...

One process runs every seed (each its own coder and inputs) and prints one
JSON line a seed. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a cell's control of correct.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    cell = spec.workload(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        result, checks, err = run.run(cell, seed, a.seconds, False, control=True)
        print("\n".join(err), file=sys.stderr)
        print(json.dumps({"workload": cell["name"], "seed": seed, "control": "bfloat16",
                          "correct": result["correct"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
