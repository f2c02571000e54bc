"""Sweep of ``qmatmul`` plans on a CUDA card: the evidence for :func:`~.qmatmul.plan`.

    python -m convnet_approximater_tpu_torch.ops.qmatmul_sweep

For each (M, K, N) of int8 ConvNeXt-T at b=64, 224^2 (and its calls per
forward), every plan the kernel takes (BM, BNW, column tiles per block, ring
depths) within 227 KB of shared memory is launched, held against
``qmatmul_ref`` bit for bit, and timed (median of 10 CUDA-event runs behind a
sleep kernel).  Prints the six fastest plans of each shape, the planner's
choice and its time, and the per-forward sums of both.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import qmatmul as Q

# (M, K, N) of the 13 qmatmul calls of int8 ConvNeXt-T at b=64, 224^2, and calls per forward
SHAPES = [((200704, 48, 96), 1), ((50176, 384, 192), 1), ((12544, 768, 384), 1),
          ((3136, 1536, 768), 1), ((200704, 96, 384), 3), ((50176, 192, 768), 3),
          ((12544, 384, 1536), 9), ((3136, 768, 3072), 3), ((200704, 384, 96), 3),
          ((50176, 768, 192), 3), ((12544, 1536, 384), 9), ((3136, 3072, 768), 3),
          ((64, 768, 1000), 1)]
RINGS = ((2, 2), (3, 2), (3, 3), (4, 3), (8, 4))


def device_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # hold the stream while the host enqueues
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def candidates(M, K, N):
    """Every (bm, bnw, ntpb, ra, sx, sb) the kernel takes for this shape."""
    kc = Q.plan(M, K, N).kc
    for bm, bnws in Q.BNWS.items():
        m_tiles = -(-M // bm)
        for bnw in bnws:
            bn = bnw if bm == 128 else 2 * bnw
            n_tiles = -(-N // bn)
            if n_tiles > 64 or (bnw < 32 and M > 1000):
                continue
            splits = {1, n_tiles} | {max(1, n_tiles // -(-g * Q.SMS // m_tiles)) for g in (1, 2)}
            for ntpb in sorted(splits):
                ra = kc if ntpb > 1 else min(kc, 4)
                for sx, sb in RINGS:
                    if Q.smem_bytes(bm, bn, ra, sx, sb) <= Q.SMEM_MAX:
                        yield bm, bnw, ntpb, ra, sx, sb


def main():
    if not torch.cuda.is_available():
        raise SystemExit("qmatmul_sweep needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib = Q._library()
    gen = torch.Generator().manual_seed(0)
    best_total = plan_total = 0.0
    for (M, K, N), calls in SHAPES:
        x = torch.randn(M, K, generator=gen).cuda()
        w = Q.pack_qweight(torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).cuda())
        a = torch.tensor(float(x.abs().max()) / 127.0, device="cuda")
        s, b = (torch.rand(N, generator=gen) * 0.01).cuda(), torch.randn(N, generator=gen).cuda()
        y, y_ref = torch.empty(M, N, device="cuda"), Q.qmatmul_ref(x, w, a, s, b)
        stream = torch.cuda.current_stream().cuda_stream

        def run(bm, bnw, ntpb, ra, sx, sb):
            err = lib.qmatmul_f32(x.data_ptr(), w.data_ptr(), a.data_ptr(), s.data_ptr(),
                                  b.data_ptr(), y.data_ptr(), M, K, w.shape[1], N, bm, bnw,
                                  ntpb, ra, sx, sb, stream)
            if err:
                raise RuntimeError(f"qmatmul launch failed with error {err}")

        results = []
        for c in candidates(M, K, N):
            y.zero_()
            run(*c)
            torch.cuda.synchronize()
            if not torch.equal(y, y_ref):
                raise SystemExit(f"qmatmul {(M, K, N)} plan {c}: not qmatmul_ref's bits")
            results.append((device_ms(lambda: run(*c)), c))
        results.sort()
        p = Q.plan(M, K, N)
        chosen = (p.bm, p.bnw, p.ntpb, p.ra, p.sx, p.sb)
        chosen_ms = next((t for t, c in results if c == chosen), None)
        if chosen_ms is None:
            chosen_ms = device_ms(lambda: run(*chosen))
        best_total += results[0][0] * calls
        plan_total += chosen_ms * calls
        print(f"{(M, K, N)} x{calls}: {len(results)} plans, all bit for bit; planner's "
              f"(bm, bnw, ntpb, ra, sx, sb) = {chosen}: {chosen_ms:.4f} ms; fastest:")
        for t, c in results[:6]:
            print(f"    {t:.4f} ms  {c}")
        del x, w, y, y_ref
    print(f"per int8 ConvNeXt-T forward: fastest plans {best_total:.4f} ms, planner's "
          f"{plan_total:.4f} ms")


if __name__ == "__main__":
    main()
