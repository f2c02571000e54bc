"""The benchmark of ``convnet_approximater_tpu_torch`` on NVIDIA H100s.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout, on the card
the process is started on, and prints one JSON object as its last line of
standard output: ``correct``, ``attempted``, ``failed``, the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``, with the
device's busy time, the traced window and a breakdown), ``device``, and under
``checks`` each number compared with the plain reference beside its limit
(also the last lines of standard error).  It fails, and prints no result,
without CUDA cards enough for the cell or where the process has loaded JAX or
the JAX package.  Kernel builds go to ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the checkout's root holds the program; this folder holds the harness
sys.path[:0] = [str(HERE.parent), str(HERE)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    import convnet_approximater_tpu_torch  # noqa: F401  (the program: fail here without it)

    from benchkit import recover, result, serve, spec

    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    job = {"serve": serve.run, "recover": recover.run}[cell.traffic["job"]]
    outcome = job(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    line = result.line(cell, outcome, bool(args.trace), device_info)
    found = result.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    for name, value, limit in outcome.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
