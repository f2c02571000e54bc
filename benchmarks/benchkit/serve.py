"""The ``serve`` job: a compressed model served as one CUDA graph by the
program's ``deploy.compile_serving``, in a closed loop with one client.

Set-up (``setup_s``): the dense weights and a pool of uint8 images are made on
the device from the seed; the program builds the dense model, applies the
workload's recipe (its apps through ``deploy_planner.apply_app``, its passes
from ``deploy``), captures the forward and serves one pass over the pool
untimed.  The window: the loop takes a batch from the program's ``Loader``
(the native uint8 prep in its prefetch thread, the copy and normalisation on
the card), replays the graph, takes the top-1 classes on the card and copies
them to pinned host memory, with at most ``in_flight`` batches outstanding; a
batch's latency runs from the loop taking it from the loader to its classes
being readable on the host.  It stops taking batches at ``--seconds`` and
drains; the window ends with the last batch read back.

The check, once the window has closed and the program is freed: the plain
reference in float64 on the same weights and images, over the pool batches
drawn from the seed (every answer the window served for them).  The number
compared, ``answer_err``, is the larger of the served logits' widest gap from
the reference's and the widest gap by which a served class's reference logit
lies below the reference's best, both over the batch's largest reference
logit.
"""

from __future__ import annotations

import gc
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from yardstick.recipe import read_recipe

from . import family, tracing, weights
from .seeds import sub_seed


@dataclass
class Outcome:
    e2e: Dict[str, float]
    checks: List[tuple]                       # (name, value, limit)
    correct: bool
    attempted: int
    failed: int
    memory_peak: int
    spans: Dict[str, float] = field(default_factory=dict)
    trace: Optional[tracing.Trace] = None
    control: Optional[dict] = None           # what the limits script needs
    parts: Dict[str, float] = field(default_factory=dict)  # answer_err's two terms


def normalize(u8, mean, std, dtype):
    """(B, H, W, 3) uint8 -> normalised NCHW in ``dtype``, as the loader does it."""
    m = torch.tensor(mean, dtype=dtype, device=u8.device) * 255
    s = torch.tensor(std, dtype=dtype, device=u8.device) * 255
    return ((u8.to(dtype) - m) / s).permute(0, 3, 1, 2)


def apply_recipe(model, recipe, calib, seed: int):
    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.core.approximater import build_app
    from convnet_approximater_tpu_torch.deploy_planner import apply_app
    from convnet_approximater_tpu_torch.filters import build_filter

    sites = []
    for i, step in enumerate(recipe):
        if "app" in step:
            filters = [build_filter(dict(f)) for f in step.get("filters", [])]
            n = apply_app(model, build_app(dict(step["app"])), filters,
                          torch.Generator().manual_seed(sub_seed(seed, 100 + i)))
        elif step["pass"] == "quantize_int8":
            n = deploy.quantize_int8(model, calib[:step["calib_batches"]])
        else:
            n = getattr(deploy, step["pass"])(model)
        if not n:
            raise RuntimeError(f"the recipe step {step} found nothing to rewrite")
        sites.append(n)
    return sites


class Loop:
    """The closed loop over the loader and the graph, at most ``depth``
    batches outstanding."""

    def __init__(self, compiled, loader, batch, depth, pool, device, keep=()):
        self.compiled, self.depth, self.pool = compiled, depth, pool
        self.device = device
        self.keep = set(keep)                       # pool indices whose logits are kept
        self.it = self._batches(loader)
        self.count = 0                              # batches taken, for the pool index
        pin = device.type == "cuda"
        self.host = [torch.empty(batch, dtype=torch.int64, pin_memory=pin)
                     for _ in range(depth + 1)]
        self.inflight = deque()
        self.reset()

    @staticmethod
    def _batches(loader):
        while True:
            for images, _ in loader:
                yield images

    def reset(self):
        self.latency, self.wait, self.events = [], [], []
        self.served, self.kept = [], {}             # (pool index, classes); pool index -> logits

    def _span(self, name, on):
        return torch.profiler.record_function(name) if on else _NULL

    def step(self, spans=False, events=False):
        if len(self.inflight) >= self.depth:
            self._finish(spans)
        t0 = time.perf_counter()
        with self._span("bench.next", spans):
            images = next(self.it)
        taken = time.perf_counter()
        self.wait.append(taken - t0)
        j = self.count % self.pool
        self.count += 1
        with self._span("bench.forward", spans):
            if events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            logits = self.compiled(images)
            if events:
                ev[1].record()
                self.events.append(ev)
            host = self.host[self.count % len(self.host)]
            host.copy_(logits.argmax(dim=-1), non_blocking=True)
            done = torch.cuda.Event() if self.device.type == "cuda" else None
            if done is not None:
                done.record()
        if j in self.keep:
            self.kept[j] = logits
        self.inflight.append((j, taken, done, host))

    def _finish(self, spans=False):
        j, taken, done, host = self.inflight.popleft()
        with self._span("bench.readback", spans):
            if done is not None:
                done.synchronize()
        self.latency.append(time.perf_counter() - taken)
        self.served.append((j, host.numpy().copy()))

    def drain(self, spans=False):
        while self.inflight:
            self._finish(spans)

    def close(self):
        self.it.close()  # the loader's prefetch thread stops and is joined


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        control: bool = False) -> Outcome:
    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.data import Loader
    from convnet_approximater_tpu_torch.data.datasets import ArrayDataset
    from convnet_approximater_tpu_torch.nn import channels_last

    tr, cfg = cell.traffic, cell.config
    B, S, P, depth = tr["batch"], tr["image_size"], tr["pool_batches"], tr["in_flight"]
    mean, std = tr["mean"], tr["std"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tr["tf32"])
    rw = read_recipe(cell.workload["recipe"])
    fam = family.load(cfg["family"])

    marks = [("start", t_start), ("imports and device", time.perf_counter())]
    # weights and images from the seed, on the device
    model = fam.build(cfg["model"], device)
    dense = weights.fill(model, torch.Generator(device).manual_seed(sub_seed(seed, 1)))
    pool_u8 = torch.randint(0, 256, (P * B, S, S, 3), dtype=torch.uint8, device=device,
                            generator=torch.Generator(device).manual_seed(sub_seed(seed, 2)))
    checked = sorted(np.random.default_rng(sub_seed(seed, 3)).choice(
        P, size=tr["check_batches"], replace=False).tolist())
    calib = [normalize(pool_u8[i * B:(i + 1) * B], mean, std, torch.float32).contiguous(
        memory_format=torch.channels_last) for i in range(rw.int8_calib_batches)]
    pool_np = pool_u8.cpu().numpy()  # the loader's pool lives on the host
    del pool_u8
    marks.append(("weights and pool", time.perf_counter()))

    def batch_u8(j):
        return torch.from_numpy(pool_np[j * B:(j + 1) * B]).to(device)

    # the program: the recipe, the graph, the loader
    model = channels_last(model).eval()
    apply_recipe(model, cell.workload["recipe"], calib, seed)
    model = channels_last(model).eval()
    del calib
    marks.append(("recipe", time.perf_counter()))
    x0 = torch.zeros(B, 3, S, S, device=device).contiguous(memory_format=torch.channels_last)
    compiled, _ = deploy.compile_serving(model, x0)
    marks.append(("capture", time.perf_counter()))
    loader = Loader(ArrayDataset(pool_np, np.zeros(P * B, np.int64)), B,
                    shuffle=False, drop_last=True, mean=mean, std=std, device=device)
    loop = Loop(compiled, loader, B, depth, P, device, keep=checked)
    for _ in range(P):  # one pass over the pool: every shape and the loader warm
        loop.step()
    loop.drain()
    loop.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    marks.append(("one pass over the pool", t0))
    print("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                 in zip(marks, marks[1:])), file=sys.stderr)
    first = loop.count
    while time.perf_counter() - t0 < seconds or loop.count - first < P:  # every pool batch once
        loop.step(events=trace and device.type == "cuda")
    loop.drain()
    window_s = time.perf_counter() - t0
    n = len(loop.served)
    lat_ms = np.asarray(loop.latency) * 1e3
    e2e = {"serve_img_per_s": n * B / window_s, "serve_batch_p95_ms": float(np.percentile(lat_ms, 95)),
           "setup_s": setup_s}
    spans = {"loader_wait_ms": float(np.mean(loop.wait) * 1e3), "window_s": window_s, "batches": n}
    if trace and device.type == "cuda":
        spans["replay_ms"] = float(np.mean([a.elapsed_time(b) for a, b in loop.events]))
    served, kept = loop.served, loop.kept

    traced = None
    if trace:  # a short profiled pass after the window, for the device's timeline
        loop.reset()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for _ in range(tr["trace_batches"]):
                loop.step(spans=True)
            loop.drain(spans=True)
            traced_s = time.perf_counter() - t1
        traced = tracing.read(prof, traced_s, tr["trace_batches"])
        del prof
    loop.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the check, with the program freed
    del compiled, model, loop, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = family.reference(cfg["family"])
    p64 = {k: v.double() for k, v in dense.items()}
    images = {j: normalize(batch_u8(j), mean, std, torch.float64) for j in checked}
    calib64 = [normalize(batch_u8(i), mean, std, torch.float64)
               for i in range(rw.int8_calib_batches)]
    forward = ref.build(p64, cfg["model"], rw, calib64)
    ref_logits = {j: forward(images[j]) for j in checked}
    parts = answer_parts(ref_logits, {j: kept[j].double() for j in checked}, served)
    answer = max(parts.values())
    limit = cell.workload["limits"]["answer_err"]
    checks = [("answer_err", answer, limit)]
    print(f"answer_err parts: {parts}", file=sys.stderr)
    correct = bool(answer <= limit)
    extra = None
    if control:
        extra = dict(ref=ref_logits, dense=dense, batch_u8=batch_u8, checked=checked, rw=rw)
    return Outcome(e2e, checks, correct, attempted=n, failed=0, memory_peak=peak, spans=spans,
                   trace=traced, control=extra, parts=parts)


def answer_parts(ref: dict, logits: dict, served) -> dict:
    """``logits``: the served logits' widest gap from the reference's; ``gap``:
    the widest gap by which a served class's reference logit lies below the
    reference's best; each over the largest |reference logit| of its batch.
    ``served`` lists (pool index, classes) of every batch the window served;
    those of pool indices not in ``ref`` are not checked."""
    worst = {"logits": 0.0, "gap": 0.0}
    for j, r in ref.items():
        scale = float(r.abs().max())
        worst["logits"] = max(worst["logits"], float((logits[j] - r).abs().max()) / scale)
        best = r.max(dim=1).values
        for jj, classes in served:
            if jj == j:
                got = r.gather(1, torch.as_tensor(classes, device=r.device)[:, None])[:, 0]
                worst["gap"] = max(worst["gap"], float((best - got).max()) / scale)
    return worst


def answer_err(ref: dict, logits: dict, served) -> float:
    """The number compared: the larger of :func:`answer_parts`."""
    return max(answer_parts(ref, logits, served).values())
