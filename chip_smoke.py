#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with no arguments:

1. checks for a CUDA device and prints the card's name and power limit;
2. builds the port's CUDA kernel (``msca_fused``) from the sources in the checkout;
3. holds the kernel against its plain PyTorch version (``msca_fused_ref``) at the
   four stage shapes of MSCAN-t at batch 64 and 224^2, in the dense-bank and the
   MscaRep d1+fix forms, in float32 with TF32 off; prints errors and median
   CUDA-event times;
4. drives the port's main path once, through its CLI entry point: the Runner on
   ``configs/msca-rep/msca-rep_d1_fix_mscan-t.py`` at full width (13 MSCA blocks
   swapped for MscaRep(1, fix), the SVD solved on the card, the forward timed at
   (64, 224, 224, 3) by InferenceTimeHook), checks that every forward launched the
   kernel once per MSCA block, and holds the logits against the same model run
   through the plain version; times the dense MSCAN-t the same way;
5. prints one JSON line of kernel results, then ``{"ok": true, "device": ...}``.

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
CONFIG = os.path.join(REPO, "configs", "msca-rep", "msca-rep_d1_fix_mscan-t.py")
KERNEL_TOL = 1e-5   # relative (norm) error of the kernel against its plain version
LOGITS_TOL = 1e-4   # relative error of the logits, 13 blocks deep
STAGES = [(56, 32, 3), (28, 64, 3), (14, 160, 5), (7, 256, 2)]  # (H = W, C, blocks) at 224^2
BATCH = 64


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(a, b) -> float:
    return float((a - b).norm() / b.norm())


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
            plain = [cuda_ms(lambda: fused_ops.msca_fused_ref(*args, **kw))]
            ours = [cuda_ms(lambda: fused_ops.msca_fused(*args, **kw)) for _ in range(2)]
            plain.append(cuda_ms(lambda: fused_ops.msca_fused_ref(*args, **kw)))
            rows.append(dict(form=form, shape=(BATCH, H, H, C), blocks=blocks, rel_err=err,
                             max_abs_err=abs_err, ms=float(np.median(ours)),
                             plain_ms=float(np.median(plain))))
            r = rows[-1]
            print(f"msca_fused {form:5s} x{r['shape']}: rel err {err:.3e} (bound {KERNEL_TOL}), "
                  f"max abs err {abs_err:.3e}, kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms (median of 25 CUDA-event runs, x2)")
            del args, y, y_ref
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    if not os.path.isfile(os.path.join(REPO, PACKAGE, "csrc", "msca_fused.cu")):
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
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    t0 = time.perf_counter()
    fused_ops.build()
    print(f"built msca_fused.cu in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel against its plain version at the main path's shapes ----
    gen = torch.Generator().manual_seed(0)
    rows = check_kernel(gen)

    # -- 4. the main path -------------------------------------------------
    from convnet_approximater_tpu_torch import main as cli
    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook, time_forward
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import init_weights

    work_dir = os.path.join(REPO, "build", "chip_smoke")
    fused_ops.msca_fused.launches = 0
    t0 = time.perf_counter()
    runner = cli.main(["--config", CONFIG, "--device", "cuda", "--seed", "0",
                       "--work-dir", work_dir])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
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

    x = torch.randn(2, 3, 224, 224, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
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

    # -- 5. results -------------------------------------------------------
    d1 = [r for r in rows if r["form"] == "d1fix"]
    kernels = [dict(
        name="msca_fused", route="cuda",
        source=f"{PACKAGE}/csrc/msca_fused.cu",
        replaces="convnet_approximater_tpu/ops/pallas/msca_kernels.py:267",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        # one d1+fix MSCAN-t forward at b=64: the per-stage time times the stage's blocks
        ms=sum(r["ms"] * r["blocks"] for r in d1),
        plain_ms=sum(r["plain_ms"] * r["blocks"] for r in d1),
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
