"""The check's control: the plain reference put in the program's place,
computed in float64 (53 bits) in place of u64 words, the precision below the
configuration's exact u64 words.  It has to come out as not correct.

    python3 hebench/control.py --workload <cell> --seeds 1,2,3 [--ops 32]

For each seed it makes the cell's inputs as a run does, takes `--ops` pool
rows drawn from the seed (every staged batch whole for a cell of the device
entry), computes their answers with the control, and compares them with the
exact reference as a run compares the program's.  One JSON line a seed.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hebench import driver, run  # noqa: E402


def control_rows(traffic: dict, pool: int, ops: int, seed: int) -> list:
    """The pool rows whose answers the control gives, grouped as a run keeps
    them: one row an answer, or a staged batch's rows together."""
    if traffic["pattern"] == "device_batches":
        return [driver.batch_rows(b, int(traffic["batch"]), pool)
                for b in range(int(traffic["pool_batches"]))]
    rng = np.random.default_rng([seed, 3])
    return [[int(r)] for r in rng.choice(pool, size=min(ops, pool), replace=False)]


def main(argv=None, spec=None, device=None) -> list:
    ap = argparse.ArgumentParser(prog="hebench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ops", type=int, default=32)
    args = ap.parse_args(argv)
    if spec is None:
        with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
            spec = json.load(f)
    cell, cfg, traffic = run._cell(spec, args.workload)
    import torch

    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    op = run.load("ops", cfg["op"])
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        w = op.Workload(cfg, int(traffic["pool"]), seed, device)
        rows = control_rows(traffic, w.pool, args.ops, seed)
        answer = w.reference("float64", device)
        kept = [(r, [1] * len(r), answer(r)) for r in rows]
        found = driver.compare(w, kept, w.reference("exact", device))
        found["words_checked"] = int(sum(a.size for _, _, a in kept))
        line = {"workload": cell["name"], "seed": seed, "control": "float64",
                "correct": found["mismatched_words"] == 0, **found}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
