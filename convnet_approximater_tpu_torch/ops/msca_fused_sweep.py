"""Sweep of ``msca_fused`` plans on a CUDA card: the evidence for :func:`~.msca_fused.plan`.

    python -m convnet_approximater_tpu_torch.ops.msca_fused_sweep

At each MSCA block shape of MSCAN-t at b=64, 224^2 (the dense 7/11/21 bank with
identity and the d1+fix 21-tap cascade with fix_p = 10, at the four stages),
both march kernels (march_kernel<21, 5, 4> and the general march_any_kernel)
at 1 to 3 bands are launched, held against ``msca_fused_ref`` (relative error
at most 1e-5, TF32 off) and timed (median of 10 CUDA-event runs behind a sleep
kernel).  Prints every plan's time, the planner's choice, and the per-forward
sums of the fastest plans, the planner's and march_any_kernel's fastest.  Needs
a CUDA card.
"""

from __future__ import annotations

import itertools
import subprocess

import torch

from . import msca_fused as M
from .qmatmul_sweep import device_ms

BATCH = 64
STAGES = [(56, 32, 3), (28, 64, 3), (14, 160, 5), (7, 256, 2)]  # (H = W, C, blocks)
TOL = 1e-5


def inputs(form, H, C, gen):
    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    ks = (7, 11, 21) if form == "dense" else (21,)
    w1, b1, w2, b2, ks = M.pack_cascade_weights(
        [u(k, C, scale=k ** -0.5) for k in ks], [u(C, scale=0.2) for _ in ks],
        [u(k, C, scale=k ** -0.5) for k in ks], [u(C, scale=0.2) for _ in ks])
    fix_p = 10 if form == "d1fix" else 0
    args = [u(BATCH, H, H, C), u(5, 5, C, scale=0.2), u(C, scale=0.2), w1, b1, w2, b2,
            u(C, C, scale=C ** -0.5), u(C, scale=0.2), u(2, fix_p, C) if fix_p else None]
    return [a.cuda() if a is not None else None for a in args], ks, form == "dense", fix_p


def main():
    if not torch.cuda.is_available():
        raise SystemExit("msca_fused_sweep needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib = M._library()
    gen = torch.Generator().manual_seed(0)
    for form in ("dense", "d1fix"):
        best_total = plan_total = any_total = 0.0
        for H, C, blocks in STAGES:
            args, ks, identity, fix_p = inputs(form, H, C, gen)
            x, w0, b0, w1, b1, w2, b2, wm, bm, res = args
            y_ref = M.msca_fused_ref(*args, ks=ks, identity=identity, fix_p=fix_p)
            out, attn = torch.empty_like(x), torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream

            def run(p):
                err = lib.msca_fused_f32(
                    x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), wm.data_ptr(), bm.data_ptr(),
                    res.data_ptr() if fix_p else None, attn.data_ptr(), out.data_ptr(),
                    BATCH, H, H, C, 5, len(ks), w1.shape[1], int(identity), fix_p,
                    p.K, p.g, p.warps, p.tw, p.ntiles, p.rows, p.bands, p.mix_tn, stream)
                if err:
                    raise RuntimeError(f"msca_fused launch failed with error {err}")

            results = []
            for fast, bands in itertools.product((True, False), (1, 2, 3)):
                p = M._tiles(BATCH, H, H, C, 5, ks, fast, bands)
                if p is None or any(p == q for _, q in results):
                    continue
                out.zero_()
                run(p)
                torch.cuda.synchronize()
                err = float((out - y_ref).norm() / y_ref.norm())
                if not err <= TOL:
                    raise SystemExit(f"msca_fused {form} {(BATCH, H, H, C)} plan {p}: "
                                     f"rel err {err:.3e} > {TOL}")
                results.append((device_ms(lambda: run(p)), p))
            results.sort(key=lambda r: r[0])
            chosen = M.plan(BATCH, H, H, C, 5, ks)
            chosen_ms = next(t for t, p in results if p == chosen)
            best_total += results[0][0] * blocks
            plan_total += chosen_ms * blocks
            any_total += min(t for t, p in results if p.g == 1) * blocks
            print(f"{form} {(BATCH, H, H, C)} x{blocks}: planner's (G {chosen.g}, bands "
                  f"{chosen.bands}): {chosen_ms:.4f} ms; every plan:")
            for t, p in results:
                kernel = "march_kernel" if p.g == M.FAST_G else "march_any_kernel"
                print(f"    {t:.4f} ms  {kernel}, {p.warps} warps, {p.ntiles} tiles of {p.tw}, "
                      f"{p.bands} bands of {p.rows}, {p.blocks} blocks, {p.smem} B")
            del args, x, y_ref, out, attn
        print(f"per {form} MSCAN-t forward: fastest plans {best_total:.4f} ms, planner's "
              f"{plan_total:.4f} ms, march_any_kernel's fastest {any_total:.4f} ms")


if __name__ == "__main__":
    main()
