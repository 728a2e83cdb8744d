"""The readings that the correctness limits are set from, on the card:

    python3 -m mvsbench.control --workload <cell> --seeds 11,12,... \
        [--control 3] [--seconds 3] [--out FILE]

For each seed, one run of the cell (a short window at the cell's own
load, then the check against the plain reference) prints every number
the check reads; for the first `--control` seeds it also prints the
control's: the reference computed with TF32 on, in the program's place.
One JSON line a seed, to standard output and to FILE.
"""

import argparse
import gc
import json
import sys

import torch

from mvsbench import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for k, seed in enumerate(seeds):
        result, readings = core.run(args.workload, seed, args.seconds, False,
                                    control=k < args.control)
        line = json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                           "correct": result["correct"], "failed": result["failed"],
                           "attempted": result["attempted"], "metrics": result["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
