"""The readings a cell's limit is set from, all in one process on the GPU.

    python3 portbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2

For each seed, a short window at the cell's own load compares every answer
with the plain fp32 reference, as a run does: the program on its default
path (the lower reading, over ``--seeds`` seeds), then over
``--control-seeds`` seeds the control, the plain reference with TF32 on
put in the program's place (the upper reading), and the program on bf16
operands.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIRST_SEED = 3_000_000_019


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness
    for var in harness.DEFAULT_PATH_UNSET:
        os.environ.pop(var, None)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    rows = []
    plan = [("program", n) for n in range(args.seeds)] + [
        (engine, n) for engine in ("reference_tf32", "program_bf16")
        for n in range(args.control_seeds)]
    for engine, n in plan:
        seed = FIRST_SEED + 7919 * n
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             engine=engine, log=lambda s: None)
        rows.append({"engine": engine, "seed": seed,
                     "logit_err": r["check"]["logit_err"]["value"],
                     "images": r["attempted"], "correct": r["correct"],
                     "seconds": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for engine in ("program", "reference_tf32", "program_bf16"):
        errs = [r["logit_err"] for r in rows if r["engine"] == engine]
        if errs:
            summary[engine] = {"min": min(errs), "max": max(errs),
                               "seeds": len(errs)}
    print(json.dumps({"workload": args.workload, "card": harness._card(),
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
