#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with no arguments:

1. checks for a CUDA device and prints the card's name and power limit;
2. builds the port's CUDA kernels (``msca_fused``, ``lowrank_conv``) from the
   sources in the checkout, one nvcc each, started together;
3. holds each kernel against its plain PyTorch version, in float32 with TF32
   off, at the shapes its main path gives it at batch 64 and 224^2, and prints
   errors, median CUDA-event times and each call's bound (the larger of its
   bytes over 3.35 TB/s and its FLOP over the 67 TFLOP/s float32 peak):
   ``msca_fused`` at the four stage shapes of MSCAN-t in the dense-bank and the
   MscaRep d1+fix forms; ``lowrank_conv`` at AlexNet's convs 2-5 in the
   separable and the full-bases forms;
4. drives the port's MSCAN main path once, through its CLI entry point: the
   Runner on ``configs/msca-rep/msca-rep_d1_fix_mscan-t.py`` at full width (13
   MSCA blocks swapped for MscaRep(1, fix), the SVD solved on the card, the
   forward timed at (64, 224, 224, 3) by InferenceTimeHook), checks that every
   forward launched ``msca_fused`` once per MSCA block, and holds the logits
   against the same model run through the plain version; times the dense
   MSCAN-t the same way and profiles the d1+fix forward;
5. drives the AlexNet main path the same way: the Runner on
   ``configs/low-rank-exp/low-rank-exp-v1_l2345_svd_dodecomp_alexnet.py`` (convs
   2-5 swapped for separable LowRankExpConvV1 with 8/8/6/4 bases, the SVDs on the
   card, ModelAnalysis and InferenceTimeHook), checks the 4 registered layers,
   that every forward launched ``lowrank_conv`` once per layer, and the logits
   against the plain version and the module path; times the forward with the
   plain version in place and the dense AlexNet, and profiles the low-rank
   forward; then runs the non-decomposed config once, so that the full-bases
   body runs on a real path;
6. prints one JSON line of kernel results, then ``{"ok": true, "device": ...}``.

Every failed check exits non-zero without the result lines, as does a run
without a CUDA device or outside a checkout of the repository.  Random weights
come from a seeded generator; no network is used.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "convnet_approximater_tpu_torch"
SOURCES = ("msca_fused.cu", "lowrank_conv.cu")
CONFIG = os.path.join(REPO, "configs", "msca-rep", "msca-rep_d1_fix_mscan-t.py")
ALEX_DODECOMP = os.path.join(REPO, "configs", "low-rank-exp",
                             "low-rank-exp-v1_l2345_svd_dodecomp_alexnet.py")
ALEX_SVD = os.path.join(REPO, "configs", "low-rank-exp", "low-rank-exp-v1_l2345_svd_alexnet.py")
ALEX_NAMES = ["features.3", "features.6", "features.8", "features.10"]
KERNEL_TOL = 1e-5   # relative (norm) error of a kernel against its plain version
LOGITS_TOL = 1e-4   # relative error of the logits, through the whole network
STAGES = [(56, 32, 3), (28, 64, 3), (14, 160, 5), (7, 256, 2)]  # (H = W, C, blocks) at 224^2
# AlexNet's convs 2-5 at 224^2: (H = W, C, k, padding, M bases of the config, N)
ALEX_CONVS = [(27, 64, 5, 2, 8, 192), (13, 192, 3, 1, 8, 384), (13, 384, 3, 1, 6, 256),
              (13, 256, 3, 1, 4, 256)]
BATCH = 64
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(a, b) -> float:
    return float((a - b).norm() / b.norm())


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def msca_cost(H, C, ks, identity, fix_p, k0=5):
    """(bytes, FLOP) of one msca_fused call at batch BATCH: x read and out
    written once, the weights read once; per element the k0^2 conv0, each
    branch's horizontal and vertical taps with their biases, the identity, the
    C-wide channel mix, its bias and the gate; the border fix on 2 min(H, p) rows."""
    n = BATCH * H * H * C
    per = 2 * k0 * k0 + 1 + sum(4 * k + 2 for k in ks) + int(identity) + 2 * C + 2
    flops = n * per + 2 * min(H, fix_p) * BATCH * H * C
    weights = k0 * k0 * C + C + len(ks) * (2 * max(ks) + 2) * C + C * C + C + 2 * fix_p * C
    return 4 * (2 * n + weights), flops


def lowrank_cost(H, C, k, pad, M, N, form):
    """(bytes, FLOP) of one lowrank_conv call at batch BATCH (stride 1): x read
    and y written once, the weights read once; the basis passes (kh + kw taps
    per basis and element when separable, kh kw when full) and the mix with its bias."""
    Ho = H + 2 * pad - k + 1
    P = BATCH * Ho * Ho
    taps = 2 * k if form == "sep" else k * k
    flops = 2 * P * C * M * taps + 2 * P * M * C * N + P * N
    weights = M * taps + M * C * N + N
    return 4 * (BATCH * H * H * C + P * N + weights), flops


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` CUDA-event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_pair(kernel, plain):
    """Median ms of kernel and plain version, taken in turns: plain, kernel, kernel, plain."""
    p = [cuda_ms(plain)]
    k = [cuda_ms(kernel) for _ in range(2)]
    p.append(cuda_ms(plain))
    return float(np.median(k)), float(np.median(p))


def kernel_inputs(form: str, H: int, C: int, gen):
    """Random inputs of one MSCA block of MSCAN-t: the dense (7, 11, 21) bank with
    identity, or the d1+fix single 21-tap cascade with fix_p = 10."""
    import torch

    from convnet_approximater_tpu_torch.ops.msca_fused import pack_cascade_weights

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    ks = (7, 11, 21) if form == "dense" else (21,)
    w1, b1, w2, b2, ks = pack_cascade_weights(
        [u(k, C, scale=k ** -0.5) for k in ks],
        [u(C, scale=0.2) if form == "dense" else None for _ in ks],
        [u(k, C, scale=k ** -0.5) for k in ks],
        [u(C, scale=0.2) for _ in ks])
    fix_p = 10 if form == "d1fix" else 0
    args = [u(BATCH, H, H, C), u(5, 5, C, scale=0.2), u(C, scale=0.2), w1, b1, w2, b2,
            u(C, C, scale=C ** -0.5), u(C, scale=0.2), u(2, fix_p, C) if fix_p else None]
    args = [a.cuda() if a is not None else None for a in args]
    return args, dict(ks=ks, identity=form == "dense", fix_p=fix_p)


def check_kernel(gen):
    import torch

    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    rows = []
    for form in ("dense", "d1fix"):
        for H, C, blocks in STAGES:
            args, kw = kernel_inputs(form, H, C, gen)
            y = fused_ops.msca_fused(*args, **kw)
            y_ref = fused_ops.msca_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"msca_fused {form} {(BATCH, H, H, C)}: rel err {err:.3e} > {KERNEL_TOL}")
            ms, plain_ms = time_pair(lambda: fused_ops.msca_fused(*args, **kw),
                                     lambda: fused_ops.msca_fused_ref(*args, **kw))
            nbytes, flops = msca_cost(H, C, kw["ks"], kw["identity"], kw["fix_p"])
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(form=form, shape=(BATCH, H, H, C), blocks=blocks, rel_err=err,
                             max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                             flops=flops, bound_ms=b_ms))
            print(f"msca_fused {form:5s} x{rows[-1]['shape']}: rel err {err:.3e} (bound "
                  f"{KERNEL_TOL}), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 25 CUDA-event runs, x2); bound {b_ms:.4f} ms "
                  f"by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), "
                  f"roofline share {b_ms / ms:.1%}")
            del args, y, y_ref
    return rows


def check_lowrank_kernel(gen):
    import torch

    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    rows = []
    for H, C, k, pad, M, N in ALEX_CONVS:
        for form in ("sep", "full"):
            taps = dict(v=r(M, k), h=r(M, k)) if form == "sep" else dict(bases=r(M, k, k))
            x, A, b = r(BATCH, H, H, C), r(M * C, N, scale=(M * C) ** -0.5), r(N, scale=0.1)
            kw = dict(kernel_size=(k, k), stride=(1, 1), padding=(pad, pad), **taps)
            y = lowrank_ops.lowrank_conv(x, A, b, **kw)
            y_ref = lowrank_ops.lowrank_conv_ref(x, A, b, **kw)
            torch.cuda.synchronize()
            err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"lowrank_conv {form} {(BATCH, H, H, C)} M={M} N={N}: rel err {err:.3e} "
                     f"> {KERNEL_TOL}")
            ms, plain_ms = time_pair(lambda: lowrank_ops.lowrank_conv(x, A, b, **kw),
                                     lambda: lowrank_ops.lowrank_conv_ref(x, A, b, **kw))
            nbytes, flops = lowrank_cost(H, C, k, pad, M, N, form)
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(form=form, shape=(BATCH, H, H, C), rel_err=err, max_abs_err=abs_err,
                             ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops, bound_ms=b_ms))
            print(f"lowrank_conv {form:4s} x{(BATCH, H, H, C)} k={k} M={M} N={N}: rel err "
                  f"{err:.3e} (bound {KERNEL_TOL}), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (median of 25 CUDA-event runs, x2); bound "
                  f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), "
                  f"roofline share {b_ms / ms:.1%}")
            del x, A, b, taps, y, y_ref
    return rows


def reset_counts():
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    fused_ops.msca_fused.launches = 0
    lowrank_ops.lowrank_conv.launches = 0


def run_cli(config, work_dir):
    """The port's CLI on ``config``, seed 0, on the card; (runner, seconds)."""
    import torch

    from convnet_approximater_tpu_torch import main as cli

    t0 = time.perf_counter()
    runner = cli.main(["--config", config, "--device", "cuda", "--seed", "0",
                       "--work-dir", work_dir])
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def forwards_of(runner) -> int:
    """Forwards the hooks ran (ModelAnalysis: 1, InferenceTimeHook: warm-ups + timed)."""
    return sum(getattr(h, "forwards", 0) for h in runner.hooks)


def images(gen, size=224):
    import torch

    return torch.randn(2, 3, size, size, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)


def run_mscan(gen):
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook, time_forward
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    reset_counts()
    runner, run_s = run_cli(CONFIG, os.path.join(REPO, "build", "chip_smoke"))
    launches = fused_ops.msca_fused.launches
    model = runner.model
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    mscas = [m for m in model.modules() if isinstance(m, MSCA)]
    if model.length_switchable != 13 or len(mscas) != 13:
        fail(f"expected 13 MSCA blocks, registered {model.length_switchable}, found {len(mscas)}")
    if not all(m.can_fuse() for m in mscas):
        fail("an MscaRep'd MSCA block cannot take the fused kernel")
    if launches != 13 * hook.forwards or launches == 0:
        fail(f"msca_fused launched {launches} times in {hook.forwards} forwards, "
             f"expected {13 * hook.forwards}")
    d1_ms = hook.result["median_ms"]
    print(f"main path: Runner on {os.path.relpath(CONFIG, REPO)} in {run_s:.2f} s; "
          f"{hook.forwards} forwards launched msca_fused {launches} times (13 per forward)")

    x = images(gen)
    with torch.no_grad():
        y = model(x)
        with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
            y_plain = model(x)
            plain_ms = float(np.median(time_forward(model, hook.input_size, "cuda",
                                                    hook.num_iters, hook.warmup)))
        for m in mscas:
            m.train()  # the module path: conv0 -> strip convs -> fix -> channel mix
        y_module = model(x)
        for m in mscas:
            m.eval()
    torch.cuda.synchronize()
    if tuple(y.shape) != (2, 1000) or not torch.isfinite(y).all():
        fail(f"logits of shape {tuple(y.shape)} or not finite")
    err_plain, err_module = rel_err(y, y_plain), rel_err(y, y_module)
    print(f"d1+fix logits (2, 1000): rel err {err_plain:.3e} against msca_fused_ref, "
          f"{err_module:.3e} against the module path (bound {LOGITS_TOL})")
    if err_plain > LOGITS_TOL or err_module > LOGITS_TOL:
        fail("d1+fix logits disagree with the plain versions")

    dense = MSCAN_Classifier(num_classes=1000)
    init_weights(dense, torch.Generator().manual_seed(0))
    dense = dense.cuda().to(memory_format=torch.channels_last).eval()
    fused_ops.msca_fused.launches = 0
    dense_times = time_forward(dense, hook.input_size, "cuda", hook.num_iters, hook.warmup)
    if fused_ops.msca_fused.launches != 13 * (hook.num_iters + hook.warmup):
        fail("the dense MSCAN-t forward did not launch msca_fused once per block")
    dense_ms = float(np.median(dense_times))
    b = hook.input_size[0]
    print(f"MSCAN-t d1+fix forward (64, 224, 224, 3) f32: median {d1_ms:.3f} ms "
          f"({b / d1_ms * 1e3:.1f} img/s); with msca_fused_ref in place of the kernel "
          f"{plain_ms:.3f} ms")
    print(f"MSCAN-t dense forward (64, 224, 224, 3) f32: median {dense_ms:.3f} ms "
          f"({b / dense_ms * 1e3:.1f} img/s); dense / d1+fix = {dense_ms / d1_ms:.4f}")
    profile_forward("MSCAN-t d1+fix", model, hook.input_size)
    del runner, model, dense
    torch.cuda.empty_cache()
    return launches


def profile_forward(name, model, input_size, n: int = 3):
    """Device time per forward by kernel, from torch.profiler over ``n`` forwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    B, H, W, C = input_size
    x = torch.zeros(B, C, H, W, device="cuda").contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        rows.append((us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print("profile: torch.profiler recorded no device time (not measured)")
        return
    print(f"profile of the {name} forward {tuple(input_size)} (torch.profiler, {n} "
          f"forwards): device time {total:.3f} ms per forward, wall {wall_ms:.3f} ms under the "
          f"profiler; by kernel (ms per forward, launches per forward):")
    for ms, count, name in rows[:12]:
        print(f"  {ms:8.4f} ms  x{count:<3d} {name[:100]}")


def run_alexnet(gen, config, separable: bool, work_dir: str, extras: bool):
    """Drive AlexNet with LowRankExpConvV1 on convs 2-5 through the CLI and
    check it; with ``extras``, also time the plain version in place and the
    dense AlexNet and profile the forward.  Returns the kernel's launch count."""
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook, time_forward
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
    from convnet_approximater_tpu_torch.models import AlexNet
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    name = os.path.relpath(config, REPO)
    reset_counts()
    runner, run_s = run_cli(config, work_dir)
    launches = lowrank_ops.lowrank_conv.launches
    model = runner.model
    forwards = forwards_of(runner)
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    layers = [m for m in model.modules() if isinstance(m, LowRankExpConvV1)]
    if model.switchable_names != ALEX_NAMES or len(layers) != 4:
        fail(f"{name}: registered {model.switchable_names}, expected {ALEX_NAMES}")
    if not all(m.uses_kernel() for m in layers):
        fail(f"{name}: a LowRankExpConvV1 layer does not dispatch to lowrank_conv")
    if not all(hasattr(m.s_conv, "v_conv") == separable for m in layers):
        fail(f"{name}: expected {'separable' if separable else 'full'} bases in every layer")
    if launches != 4 * forwards or launches == 0:
        fail(f"{name}: lowrank_conv launched {launches} times in {forwards} forwards, "
             f"expected {4 * forwards}")
    with open(os.path.join(work_dir, "run.log")) as f:
        macs_line = [ln.strip() for ln in f if "Model MACs: " in ln]
    if not macs_line:
        fail(f"{name}: ModelAnalysis logged no 'Model MACs' line")
    low_ms = hook.result["median_ms"]
    print(f"main path: Runner on {name} in {run_s:.2f} s; {forwards} forwards launched "
          f"lowrank_conv {launches} times (4 per forward); {macs_line[0].split(' - ')[-1]}")

    x = images(gen)
    with torch.no_grad():
        y = model(x)
        with mock.patch.object(lowrank_ops, "lowrank_conv", lowrank_ops.lowrank_conv_ref):
            y_plain = model(x)
            if extras:
                plain_ms = float(np.median(time_forward(model, hook.input_size, "cuda",
                                                        hook.num_iters, hook.warmup)))
        for m in layers:
            m.train()  # the module path: s_conv -> d_conv
        y_module = model(x)
        for m in layers:
            m.eval()
    torch.cuda.synchronize()
    if tuple(y.shape) != (2, 10) or not torch.isfinite(y).all():
        fail(f"{name}: logits of shape {tuple(y.shape)} or not finite")
    err_plain, err_module = rel_err(y, y_plain), rel_err(y, y_module)
    print(f"{name} logits (2, 10): rel err {err_plain:.3e} against lowrank_conv_ref, "
          f"{err_module:.3e} against the module path (bound {LOGITS_TOL})")
    if err_plain > LOGITS_TOL or err_module > LOGITS_TOL:
        fail(f"{name}: logits disagree with the plain versions")
    b = hook.input_size[0]
    print(f"AlexNet low-rank forward {tuple(hook.input_size)} f32 ({name}): median "
          f"{low_ms:.3f} ms ({b / low_ms * 1e3:.1f} img/s)")
    if extras:
        dense = AlexNet()
        init_weights(dense, torch.Generator().manual_seed(0))
        dense = dense.cuda().to(memory_format=torch.channels_last).eval()
        dense_ms = float(np.median(time_forward(dense, hook.input_size, "cuda",
                                                hook.num_iters, hook.warmup)))
        print(f"AlexNet low-rank forward with lowrank_conv_ref in place of the kernel: median "
              f"{plain_ms:.3f} ms")
        print(f"AlexNet dense forward {tuple(hook.input_size)} f32: median {dense_ms:.3f} ms "
              f"({b / dense_ms * 1e3:.1f} img/s); dense / low-rank = {dense_ms / low_ms:.4f}")
        del dense
        profile_forward("low-rank AlexNet", model, hook.input_size)
    del runner, model
    torch.cuda.empty_cache()
    return launches


def per_forward(rows, weight, kernel):
    """The kernels-line entry of one forward: rows weighted by calls per forward."""
    nbytes = sum(r["bytes"] * weight(r) for r in rows)
    flops = sum(r["flops"] * weight(r) for r in rows)
    b_ms, b_by = bound(nbytes, flops)
    return dict(kernel, ms=sum(r["ms"] * weight(r) for r in rows),
                plain_ms=sum(r["plain_ms"] * weight(r) for r in rows),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    if not all(os.path.isfile(os.path.join(REPO, PACKAGE, "csrc", s)) for s in SOURCES):
        fail(f"{PACKAGE}/ not found beside chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, REPO)

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN and matmul: the plain versions run in full float32")

    # -- 2. build ---------------------------------------------------------
    from convnet_approximater_tpu_torch.ops import build as build_ops
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    t0 = time.perf_counter()
    seconds = build_ops.build_all(SOURCES)
    fused_ops.build()
    lowrank_ops.build()
    print(f"built {', '.join(f'{s} in {t:.2f} s' for s, t in seconds.items())} "
          f"(one nvcc each, in parallel; {time.perf_counter() - t0:.2f} s in all)")

    # -- 3. kernels against their plain versions at the main paths' shapes
    gen = torch.Generator().manual_seed(0)
    msca_rows = check_kernel(gen)
    lowrank_rows = check_lowrank_kernel(gen)

    # -- 4./5. the main paths ---------------------------------------------
    msca_launches = run_mscan(gen)
    lowrank_launches = run_alexnet(gen, ALEX_DODECOMP, True,
                                   os.path.join(REPO, "build", "chip_smoke_alexnet"), extras=True)
    run_alexnet(gen, ALEX_SVD, False, os.path.join(REPO, "build", "chip_smoke_alexnet_full"),
                extras=False)

    # -- 6. results -------------------------------------------------------
    # each entry is one forward at b=64, 224^2: the time per call times the calls per forward
    blocks = {H: n for H, _, n in STAGES}
    kernels = [
        per_forward([r for r in msca_rows if r["form"] == "d1fix"],
                    lambda r: blocks[r["shape"][1]], dict(
                        name="msca_fused", route="cuda", source=f"{PACKAGE}/csrc/msca_fused.cu",
                        replaces="convnet_approximater_tpu/ops/pallas/msca_kernels.py:267",
                        launches=msca_launches,
                        max_abs_err=max(r["max_abs_err"] for r in msca_rows))),
        per_forward([r for r in lowrank_rows if r["form"] == "sep"], lambda r: 1, dict(
            name="lowrank_conv", route="cuda", source=f"{PACKAGE}/csrc/lowrank_conv.cu",
            replaces="convnet_approximater_tpu/ops/pallas/lowrank_kernels.py:123",
            launches=lowrank_launches,
            max_abs_err=max(r["max_abs_err"] for r in lowrank_rows))),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
