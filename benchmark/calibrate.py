"""Readings that the limits of `correct` are set from, for one cell, in
one process on the card:

    python3 -m benchmark.calibrate --workload <cell> --seed0 <n> --seeds 12 \
        --control-seeds 3 --seconds 3 [--out chiprun_out/calib_<cell>.jsonl]

For each of `--seeds` seeds (seed0, seed0 + 1, ...) a short run of the
cell at its own load gives the program's numbers (the lower readings);
for the first `--control-seeds` of them the reference takes the
program's place with its detector's, then its recognizer's operands one
precision step lower (float8 e4m3 for the configuration's bfloat16),
which gives the upper readings. One JSON line per run on standard
output (and in --out). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import run as bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed0", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        bench.log("calibration runs on the card")
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for k in range(args.seeds):
            seed = args.seed0 + k
            modes = [None] + (["det", "rec"] if k < args.control_seeds else [])
            for mode in modes:
                readings = {}
                res = bench.run(args.workload, seed, args.seconds, False, control=mode,
                                readings=readings)
                line = json.dumps({
                    "workload": args.workload, "seed": seed,
                    "side": "program" if mode is None else f"control_{mode}",
                    "numbers": readings,
                    "metrics": {m: v["value"] for m, v in res["metrics"].items()},
                    "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                })
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
