"""The ``recover`` job: the program's recovery fine-tune of a lossy rewrite,
``hooks/finetune.py::L2Reconstruct.train_step``, stepped back to back.

Set-up (``setup_s``): the dense weights and a pool of uint8 images are made on
the device from the seed; the recipe's app is registered, initialized and
solved on the model as the Runner's first phases do (each site a
``Substitution``); the hook builds its asymmetric teacher (the dense original)
and its ``MaskedOptimizer`` over every parameter, the student keeps its new
branches, and the strips train.  The first three steps run in set-up through
the window's own call on the first three pool batches, and are what the check
follows.  The window: the loop takes a batch from the program's ``Loader`` and
runs ``train_step``, each step's loss copied to the host with at most
``in_flight`` steps outstanding, until ``--seconds``.

The check, once the window has closed and the program is freed: the plain
reference (``reference/recovery.py``, float64) follows the same three steps
from the same weights and images.  Compared: each step's loss, the first
step's gradient as the optimizer got it (its first moment after one step over
``1 - b1``) and the change of the trainable parameters over the three steps,
the last two leaf by leaf (:func:`compare`).  A leaf whose reference gradient
is under a thousandth of the median leaf's takes no part.
"""

from __future__ import annotations

import gc
import sys
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from . import family, tracing, weights
from .seeds import sub_seed
from .serve import Outcome, normalize

CHECKED_STEPS = 3


def build_program(model, workload: dict, seed: int, steps_per_epoch: int):
    """(hook, trainable names) of the program's recovery on ``model``: the
    recipe's app through the Runner's register, initialize and optimize
    phases, then the hook's teacher, student and optimizer as its
    ``after_optimize`` makes them."""
    from convnet_approximater_tpu_torch.core.approximater import build_app
    from convnet_approximater_tpu_torch.filters import build_filter
    from convnet_approximater_tpu_torch.hooks.finetune import L2Reconstruct, make_optimizer
    from convnet_approximater_tpu_torch.utils.config import Config

    (step,) = workload["recipe"]
    app = build_app(dict(step["app"]))
    model.register_switchable(app.src_type, [build_filter(dict(f)) for f in step.get("filters", [])])
    generator = torch.Generator().manual_seed(sub_seed(seed, 100))
    for idx in range(model.length_switchable):
        sub = app.initialize(model.get_switchable_module(idx), generator)
        model.set_switchable_module(idx, sub.eval())
    for idx in range(model.length_switchable):
        app.optimize(model.get_switchable_module(idx))
    if not model.length_switchable:
        raise RuntimeError(f"the recipe step {step} found nothing to rewrite")
    runner = SimpleNamespace(model=model, device=next(model.parameters()).device,
                             model_before_passes=None, app=app,
                             cfg=Config(dict(work_dir=None, seed=seed, filters=step.get("filters"))))
    rec = workload["recovery"]
    hook = L2Reconstruct(runner, 50, **rec)
    hook.teacher = hook._build_teacher()
    for sub in model.switchable_modules():
        sub.switch_new(remove_old=True)
        sub.capture = True
    hook.optimizer, _ = make_optimizer(model.named_parameters(), hook.optim_args, hook.sche_args,
                                       steps_per_epoch)
    model.train()
    return hook, hook.trainable(-1)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: bool = False) -> Outcome:
    from convnet_approximater_tpu_torch.data import Loader
    from convnet_approximater_tpu_torch.data.datasets import ArrayDataset
    from convnet_approximater_tpu_torch.nn import channels_last

    tr, cfg = cell.traffic, cell.config
    B, S, P, depth = tr["batch"], tr["image_size"], tr["pool_batches"], tr["in_flight"]
    mean, std = tr["mean"], tr["std"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tr["tf32"])
    fam = family.load(cfg["family"])
    cuda = device.type == "cuda"

    model = fam.build(cfg["model"], device)
    dense = weights.fill(model, torch.Generator(device).manual_seed(sub_seed(seed, 1)))
    pool = torch.randint(0, 256, (P * B, S, S, 3), dtype=torch.uint8, device=device,
                         generator=torch.Generator(device).manual_seed(sub_seed(seed, 2)))
    pool_np = pool.cpu().numpy()
    del pool
    hook, mask = build_program(channels_last(model), cell.workload, seed, P)
    loader = Loader(ArrayDataset(pool_np, np.zeros(P * B, np.int64)), B, shuffle=False,
                    drop_last=True, mean=mean, std=std, device=device)

    def batches():
        while True:
            for images, labels in loader:
                yield images, labels

    it = batches()
    named = dict(model.named_parameters())
    leaves = sorted(mask)
    before = {n: named[n].detach().clone() for n in leaves}
    losses, first_mu = [], None
    for i in range(CHECKED_STEPS):  # the steps the reference follows, through the window's call
        images, labels = next(it)
        losses.append(hook.train_step(images, labels, mask)[0])
        if i == 0:
            first_mu = {n: hook.optimizer.state[n]["mu"].clone() for n in leaves}
    after = {n: named[n].detach().clone() for n in leaves}
    losses = [float(v) for v in losses]
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    host = [torch.empty((), pin_memory=cuda) for _ in range(depth + 1)]
    pending, wait, step_events = deque(), [], []
    count = 0

    def step(spans=False, events=False):
        nonlocal count
        if len(pending) >= depth:
            finish(spans)
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench.next") if spans else _null()):
            images, labels = next(it)
        wait.append(time.perf_counter() - t0)
        with (torch.profiler.record_function("bench.forward") if spans else _null()):
            if events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            loss = hook.train_step(images, labels, mask)[0]
            if events:
                ev[1].record()
                step_events.append(ev)
            buf = host[count % len(host)]
            buf.copy_(loss, non_blocking=True)
            done = torch.cuda.Event() if cuda else None
            if done is not None:
                done.record()
        count += 1
        pending.append((done, buf))

    def finish(spans=False):
        done, buf = pending.popleft()
        with (torch.profiler.record_function("bench.readback") if spans else _null()):
            if done is not None:
                done.synchronize()
        if not np.isfinite(float(buf)):
            raise FloatingPointError("a training step's loss is not finite")

    def drain(spans=False):
        while pending:
            finish(spans)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = 0
    while time.perf_counter() - t0 < seconds or steps < 1:
        step(events=trace and cuda)
        steps += 1
    drain()
    window_s = time.perf_counter() - t0
    e2e = {"train_img_per_s": steps * B / window_s, "setup_s": setup_s}
    spans = {"loader_wait_ms": float(np.mean(wait) * 1e3), "window_s": window_s, "steps": steps}
    if step_events:
        spans["step_ms"] = float(np.mean([a.elapsed_time(b) for a, b in step_events]))

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for _ in range(tr["trace_steps"]):
                step(spans=True)
            drain(spans=True)
            traced_s = time.perf_counter() - t1
        traced = tracing.read(prof, traced_s, tr["trace_steps"])
        del prof
    it.close()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    program = dict(losses=losses, mu=first_mu, before=before, after=after)
    del hook, model, named, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, parts, ref = check(cell, dense, pool_np, program, device)
    correct = all(value <= limit for _, value, limit in checks)
    print(f"check parts: {parts}", file=sys.stderr)
    extra = dict(dense=dense, pool_np=pool_np, ref=ref) if control else None
    return Outcome(e2e, checks, correct, attempted=steps, failed=0, memory_peak=peak, spans=spans,
                   trace=traced, control=extra, parts=parts)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def reference_run(cell, dense, pool_np, device, dtype=torch.float64) -> dict:
    from reference import recovery

    tr, rec = cell.traffic, cell.workload["recovery"]
    B = tr["batch"]
    p = {k: v.to(dtype) for k, v in dense.items()}
    xs = [normalize(torch.from_numpy(pool_np[i * B:(i + 1) * B]).to(device), tr["mean"],
                    tr["std"], dtype) for i in range(CHECKED_STEPS)]
    opt = rec["optim_args"]
    return recovery.train(p, cell.config["model"], xs, float(opt["lr"]),
                          float(opt["weight_decay"]), float(opt.get("eps", 1e-8)))


def as_steps(program: dict) -> dict:
    """The program's three steps in the reference's terms: each step's loss,
    the first step's gradient (its first moment over ``1 - b1``) and the
    change over the steps, by leaf name."""
    from reference.recovery import B1

    return dict(losses=program["losses"],
                grad={n: m / (1 - B1) for n, m in program["mu"].items()},
                change={n: program["after"][n] - program["before"][n] for n in program["mu"]})


def compare(steps: dict, ref: dict) -> dict:
    """The numbers of three steps (:func:`as_steps`) against the reference's:
    ``loss_err``, the widest relative gap of a step's loss; for the first
    gradient and the change, each leaf's gap between the norms over the larger
    of the reference's norm of the leaf and of the median leaf, the median over
    the leaves (``*_median_err``, compared: steady from seed to seed) and the
    worst leaf (``*_worst_err``, recorded: Adam's first steps turn a gradient
    element's rounding near zero into a whole step of the rate, so one small
    leaf's change swings from seed to seed, in a float32 reference alike)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(steps["losses"], ref["losses"]))
    g_ref = {n: float(t.norm()) for n, t in ref["grad"].items()}
    median = float(np.median(list(g_ref.values())))
    kept = [n for n, g in g_ref.items() if g >= 1e-3 * median]
    out = dict(loss_err=loss)
    for key in ("grad", "change"):
        norms = {n: float(ref[key][n].norm()) for n in kept}
        med = float(np.median(list(norms.values())))
        gaps = [abs(float(steps[key][n].double().norm()) - norms[n]) / max(norms[n], med)
                for n in kept]
        out[f"{key}_median_err"] = float(np.median(gaps))
        out[f"{key}_worst_err"] = max(gaps)
    return dict(out, leaves=len(kept), leaves_left_out=len(g_ref) - len(kept))


COMPARED = ("loss_err", "grad_median_err", "change_median_err")


def check(cell, dense, pool_np, program, device):
    ref = reference_run(cell, dense, pool_np, device)
    parts = compare(as_steps(program), ref)
    limits = cell.workload["limits"]
    return [(k, parts[k], limits[k]) for k in COMPARED], parts, ref
