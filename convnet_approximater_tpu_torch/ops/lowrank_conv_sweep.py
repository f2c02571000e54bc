"""Sweep of ``lowrank_conv`` plans on a CUDA card: the evidence for :func:`~.lowrank_conv.plan`.

    python -m convnet_approximater_tpu_torch.ops.lowrank_conv_sweep

At the scheme-1 shapes of the configs at b=64, 224^2, with separable bases
(the full-bases form runs the same kernel on its taps): AlexNet's convs 2-5
(the dodecomp config's 8/8/6/4 bases), ResNet-18's 16 block 3x3s (4 bases;
stride 2 at the first conv of stages 2-4) and VGG-16's convs 2-13 (16 bases),
every output tile ``bn`` in ``BNS`` at chains of 2, 4, 8 and 16 groups (and the
planner's) between float32 sums is launched, held against ``lowrank_conv_ref``
(TF32 off) and timed (median of 10 CUDA-event runs behind a sleep kernel).
Prints every plan's time and relative error, the planner's choice, and per
model the per-forward sums of the planner's and of the fastest plans within
1e-5.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess

import torch

from . import lowrank_conv as L
from .qmatmul_sweep import device_ms

BATCH = 64
# the scheme-1 convs at 224^2: model -> [(H = W, C, k, padding, stride, M bases, N, calls
# per forward)]
CONVS = {
    "AlexNet": [(27, 64, 5, 2, 1, 8, 192, 1), (13, 192, 3, 1, 1, 8, 384, 1),
                (13, 384, 3, 1, 1, 6, 256, 1), (13, 256, 3, 1, 1, 4, 256, 1)],
    "ResNet-18": [(56, 64, 3, 1, 1, 4, 64, 4), (56, 64, 3, 1, 2, 4, 128, 1),
                  (28, 128, 3, 1, 1, 4, 128, 3), (28, 128, 3, 1, 2, 4, 256, 1),
                  (14, 256, 3, 1, 1, 4, 256, 3), (14, 256, 3, 1, 2, 4, 512, 1),
                  (7, 512, 3, 1, 1, 4, 512, 3)],
    "VGG-16": [(224, 64, 3, 1, 1, 16, 64, 1), (112, 64, 3, 1, 1, 16, 128, 1),
               (112, 128, 3, 1, 1, 16, 128, 1), (56, 128, 3, 1, 1, 16, 256, 1),
               (56, 256, 3, 1, 1, 16, 256, 2), (28, 256, 3, 1, 1, 16, 512, 1),
               (28, 512, 3, 1, 1, 16, 512, 2), (14, 512, 3, 1, 1, 16, 512, 3)],
}
CHAINS = (2, 4, 8, 16)
TOL = 1e-5


def main():
    if not torch.cuda.is_available():
        raise SystemExit("lowrank_conv_sweep needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator().manual_seed(0)
    for model, convs in CONVS.items():
        plan_total, best_total = 0.0, 0.0
        for conv in convs:
            chosen_ms, best_ms = sweep(model, *conv, gen)
            plan_total += chosen_ms * conv[-1]
            best_total += best_ms * conv[-1]
        print(f"per {model} scheme-1 forward: planner's plans {plan_total:.4f} ms, fastest plans "
              f"within {TOL} {best_total:.4f} ms")


def sweep(model, H, C, k, pad, stride, M, N, calls, gen):
    """Every plan of one shape, printed; returns (the planner's ms, the fastest ms
    of the plans within TOL)."""
    lib = L._library()

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    v, h = r(M, k), r(M, k)
    x, A, b = r(BATCH, H, H, C), r(M * C, N, scale=(M * C) ** -0.5), r(N, scale=0.1)
    geometry = ((k, k), (stride, stride), (pad, pad))
    y_ref = L.lowrank_conv_ref(x, A, b, v=v, h=h, kernel_size=(k, k), stride=(stride, stride),
                               padding=(pad, pad))
    packed = L.pack_kernel_weights(A, v=v, h=h)
    y = torch.empty_like(y_ref)
    stream = torch.cuda.current_stream().cuda_stream

    def run(p):
        err = lib.lowrank_conv_f32(
            x.data_ptr(), packed["w"].data_ptr(), packed["taps"].data_ptr(), b.data_ptr(),
            y.data_ptr(), BATCH, H, H, C, N, p.ms, p.slabs, k, k, stride, stride, pad, pad,
            p.bn, p.qpg, p.rw, p.stages, p.chain, stream)
        if err:
            raise RuntimeError(f"lowrank_conv launch failed with error {err}")

    chosen = L.plan(BATCH, H, H, C, M, N, *geometry)
    results = []
    for bn in L.BNS:
        for chain in sorted(set(CHAINS) | {chosen.chain}):
            p = L._tiles(BATCH, H, H, C, M, N, *geometry, bn, chain)
            if p is None:
                continue
            y.zero_()
            run(p)
            torch.cuda.synchronize()
            err = float((y - y_ref).norm() / y_ref.norm())
            results.append((device_ms(lambda: run(p)), err, p))
    results.sort(key=lambda t: t[0])
    chosen_ms, chosen_err = next((t, e) for t, e, p in results if p == chosen)
    if not chosen_err <= TOL:
        raise SystemExit(f"lowrank_conv {model} {(BATCH, H, H, C)}: the planner's plan {chosen} "
                         f"has rel err {chosen_err:.3e} > {TOL}")
    print(f"{model} {(BATCH, H, H, C)} k={k} stride={stride} M={M} N={N} x{calls}/forward: "
          f"planner's (BN {chosen.bn}, chain {chosen.chain}): {chosen_ms:.4f} ms, rel err "
          f"{chosen_err:.3e}; every plan:")
    for t, e, p in results:
        print(f"    {t:.4f} ms  rel err {e:.3e}{'' if e <= TOL else ' (over 1e-5)'}  BN {p.bn}, "
              f"chain {p.chain} groups ({p.chain * p.ms // 2} k-steps), {p.qpg} quads x "
              f"{p.rw} rows, {p.stages} stages, {p.row_tiles} x {p.col_tiles} blocks, "
              f"{p.smem} B, estimate {p.cost:.0f}")
    return chosen_ms, min(t for t, e, p in results if e <= TOL)


if __name__ == "__main__":
    main()
