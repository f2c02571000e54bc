"""Operations and bytes of the port's kernel calls, and the H100's peaks.

Frozen here so that the yardstick does not move with the program: each count
is of the work that a call's shapes need, whatever implements it.  Copied from
``chip_smoke.py`` (``PEAK_*``, ``bound``, ``msca_cost``, ``cascade_cost``,
``qmm_cost``) with the batch as an argument.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates, at its 700 W limit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_F32 = 67e12      # float32 outside the tensor cores, FLOP/s
PEAK_TF32 = 495e12    # TF32 tensor cores, FLOP/s
PEAK_INT8 = 1979e12   # int8 tensor cores, OP/s


def bound(nbytes: float, flops: float, peak: float = PEAK_F32) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory's peak and the operations over
    ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def msca_cost(H: int, C: int, ks: Sequence[int], identity: bool, fix_p: int, k0: int,
              batch: int) -> Tuple[int, int]:
    """(bytes, FLOP) of one ``msca_fused`` call on a (batch, H, H, C) float32
    map: x read and out written once, the weights read once; per element the
    k0^2 conv0, each branch's horizontal and vertical taps with their biases,
    the identity, the C-wide channel mix, its bias and the gate; the border fix
    on 2 min(H, p) rows."""
    n = batch * H * H * C
    per = 2 * k0 * k0 + 1 + sum(4 * k + 2 for k in ks) + int(identity) + 2 * C + 2
    flops = n * per + 2 * min(H, fix_p) * batch * H * C
    weights = k0 * k0 * C + C + len(ks) * (2 * max(ks) + 2) * C + C * C + C + 2 * fix_p * C
    return 4 * (2 * n + weights), flops


def cascade_cost(H: int, C: int, ks: Sequence[int], identity: bool,
                 batch: int) -> Tuple[int, int]:
    """(bytes, FLOP) of one ``parallel_cascade`` call on a (batch, H, H, C)
    float32 map: x read and out written once, the packed taps and biases read
    once; per element each branch's horizontal and vertical taps with their
    biases, and the identity."""
    n = batch * H * H * C
    flops = n * (sum(4 * k + 2 for k in ks) + int(identity))
    return 4 * (2 * n + len(ks) * (2 * max(ks) + 2) * C), flops


def qmm_cost(M: int, K: int, N: int) -> Tuple[int, int]:
    """(bytes, int8 operations) of one ``qmatmul`` call: x (float32) read and y
    (float32) written once, the int8 weight, its scales and the bias read once;
    2 M N K operations of the product."""
    return 4 * M * K + K * N + 4 * (2 * N + 1) + 4 * M * N, 2 * M * N * K


def least_seconds(calls) -> float:
    """The least time of a list of ``(bytes, operations, peak)`` calls, each
    bounded on its own and summed."""
    return sum(bound(b, f, p)[0] for b, f, p in calls)
