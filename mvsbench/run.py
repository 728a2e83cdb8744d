"""One run of a benchmark cell on this machine's card:

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, the last
of standard output, and every number the correctness check compared
beside its limit as the last lines of standard error. Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell
asks for), or when JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "deep3d_aerial_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from mvsbench import core

    result, _ = core.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
