"""The readings that a cell's check limits are set from, on the chip.

    python3 benchmarks/limits.py --workload <cell> --seeds 101 102 ... --seconds 3 \\
        [--out limits_<cell>.json] [--fault half_batch]

In one process, for each seed: one run of the cell as ``run.py`` makes it (a
short window at the cell's own load and sizes), its compared numbers, and the
control's: the plain reference put in the program's place in the precision
below the one the configuration states (the workload's ``control``: ``tf32``,
float32 with TF32 on, for a float32 cell; ``int4`` for an int8 one), read the
same way against the float64 reference.  The lower reading of a number is the
largest the program gives over the seeds, the upper the smallest the control
gives (or, for a recovery cell, a planted fault: ``--fault half_batch`` runs
the program with each batch's loss on its first half only).  A float32
witness, the reference in float32 with TF32 off, is read beside them.
``run.py`` never runs the control.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def control_reading(cell, extra, kind: str) -> dict:
    """:func:`~benchkit.serve.answer_parts` of the reference put in the
    program's place, computed as ``kind`` says, on the checked batches of a
    run: ``tf32`` (float32, TF32 on) or ``int4`` are controls; ``f32`` (float32,
    TF32 off, as served) is a witness of the rounding a float32 program has."""
    import torch

    from benchkit import family, serve

    tr, cfg = cell.traffic, cell.config
    ref = family.reference(cfg["family"])
    rw, batch_u8 = extra["rw"], extra["batch_u8"]
    if kind in ("tf32", "f32"):
        dtype, bits = torch.float32, 8
    elif kind == "int4":
        dtype, bits = torch.float64, 4
    else:
        raise ValueError(f"unknown control {kind}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = kind == "tf32"
    try:
        p = {k: v.to(dtype) for k, v in extra["dense"].items()}
        calib = [serve.normalize(batch_u8(i), tr["mean"], tr["std"], dtype)
                 for i in range(rw.int8_calib_batches)]
        forward = ref.build(p, cfg["model"], rw, calib, bits)
        logits = {j: forward(serve.normalize(batch_u8(j), tr["mean"], tr["std"], dtype)).double()
                  for j in extra["checked"]}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    served = [(j, lg.argmax(dim=1).cpu().numpy()) for j, lg in logits.items()]
    return serve.answer_parts(extra["ref"], logits, served)


def recovery_reading(cell, extra, kind: str) -> dict:
    """The compared numbers of the reference's three steps put in the
    program's place, computed as ``kind`` says: ``tf32`` (float32, TF32 on) is
    the control, ``f32`` (float32, TF32 off) a witness."""
    import torch

    from benchkit import recover

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = kind == "tf32"
    try:
        steps = recover.reference_run(cell, extra["dense"], extra["pool_np"],
                                      next(iter(extra["dense"].values())).device, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return recover.compare(steps, extra["ref"])


@contextlib.contextmanager
def half_batch():
    """The program's recovery loss on the first half of each batch only, its
    mean over those rows: a fault planted in the timed path."""
    from convnet_approximater_tpu_torch.hooks.finetune import L2Reconstruct

    loss = L2Reconstruct.loss

    def half(self, images, labels, model=None, teacher=None):
        n = images.shape[0] // 2
        return loss(self, images[:n], labels[:n], model, teacher)

    L2Reconstruct.loss = half
    try:
        yield
    finally:
        L2Reconstruct.loss = loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", choices=("half_batch",), default=None,
                    help="plant a fault in the program and read it (recovery cells)")
    args = ap.parse_args(argv)
    import torch

    from benchkit import recover, serve, spec

    cell = spec.load_cell(args.workload)
    job = {"serve": serve.run, "recover": recover.run}[cell.traffic["job"]]
    reading = control_reading if cell.traffic["job"] == "serve" else recovery_reading
    if not torch.cuda.is_available():
        raise SystemExit("limits.py needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = cell.workload["control"]
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with (half_batch() if args.fault else contextlib.nullcontext()):
            out = job(cell, seed, args.seconds, False, device, t0, control=True)
        program = dict(out.parts, **{name: value for name, value, _ in out.checks})
        row = dict(seed=seed, program=program, correct=out.correct, e2e=out.e2e)
        if not args.fault:
            for name, kind_ in (("control", kind), ("witness", "f32")):
                parts = reading(cell, out.control, kind_)
                row[name] = dict(parts, answer_err=max(parts.values())) if "answer_err" in \
                    program else parts
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)
        del out
        torch.cuda.empty_cache()
    summary = dict(workload=args.workload, control=kind, fault=args.fault, seeds=args.seeds,
                   card=torch.cuda.get_device_name(device), rows=rows, numbers={})
    for name in rows[0]["program"]:
        lower = max(r["program"][name] for r in rows)
        upper = min(r["control"][name] for r in rows) if "control" in rows[0] else None
        summary["numbers"][name] = dict(lower=lower, upper=upper)
        print(f"{args.workload}: {name} program max {lower!r} over {len(rows)} seeds"
              + (f", {kind} control min {upper!r}" if upper is not None else ""), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
