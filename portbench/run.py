"""Run one benchmark cell of repro_torch on the GPU and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``check`` last); the last lines of
standard error give each number compared beside its limit.  Exits with
another code than 0, and prints no result, without a CUDA device (or
fewer than the cell asks for), without the port under ``src/``, or if
JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BYTECODE = ".bytecode"        # under portbench/, listed in its .gitignore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no port to run: {src / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    # Where the interpreter may not write bytecode beside the sources
    # (PYTHONDONTWRITEBYTECODE, a read-only site-packages), every process
    # compiles all of torch's Python again: 6-8 s of set-up on an H100
    # host.  Bytecode goes to a fixed directory of the checkout instead:
    # the first run writes it, later runs read it.
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(ROOT / "portbench" / BYTECODE)
    marks = [("start", T0), ("python", time.perf_counter())]

    import torch
    marks.append(("import_torch", time.perf_counter()))

    from portbench import harness, spec
    for var in harness.DEFAULT_PATH_UNSET:
        os.environ.pop(var, None)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core import autotune
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        print(f"repro_torch loaded from {repro_torch.__file__}, not {src}",
              file=sys.stderr)
        return 2
    if autotune.enabled():
        print("the tuner is on; the cells run with it off", file=sys.stderr)
        return 2
    marks.append(("import_port", time.perf_counter()))

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), marks=marks,
                              log=lambda s: print(s, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
