"""Fused activation quantize + int8 matrix product: CUDA kernel wrapper, its
plain PyTorch version, and the weight packing they share.

``qmatmul`` computes ``f32(q(x) @ w_q) * (a * w_scale) + bias`` with
``q(v) = clip(round(v / a), -127, 127)`` as int8 (round half to even) and an
exact integer sum, the int8 ``QuantLinear`` of the JAX package
(``convnet_approximater_tpu/layers/quant.py``) and its fused Pallas probe
``pallas_qmatmul`` (``scripts/exp_pallas_qmatmul.py``).  It is the custom op
``qmatmul_op``: on a CUDA tensor it launches ``csrc/qmatmul.cu`` (built with
nvcc at first use), on a CPU tensor it runs :func:`qmatmul_ref`, and on any
other device the dispatcher raises.  :func:`plan` chooses the kernel's
tiles and rings for each shape, in plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .build import NAMESPACE, check_device, check_x_type, entry, in_float32, launch_range, load

INT8_MAX = 127.0
K_ALIGN = 32  # the kernel's K step (one wgmma k32); the packed weight's rows are padded to it

# the kernel's shared-memory plan (csrc/qmatmul.cu: smem_bytes) and the card's
SMS = 132               # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448      # dynamic shared memory one block may use
CHUNK = 128             # K bytes of a panel chunk and of a weight box row
X_COLS = 32             # floats of an x box row
STAGE_BYTES = 8 * 16 * 40 * 4  # the epilogue's staging, 16 x 40 floats per consumer warp
# the kernel's instantiations: per row tile BM, each warpgroup's width BNW
BNWS = {128: (128, 96, 64), 64: (128, 96, 64, 32, 16, 8)}


class QmmPlan(NamedTuple):
    """One launch's tiles: BM-row tiles, BN = BNW (BM = 128) or 2 BNW (BM = 64)
    column tiles, ``ntpb`` column tiles per block; ``ra`` K chunks of the int8
    panel held (all ``Kc`` of them, or a ring of ``ra`` when the block takes one
    column tile); ``sx`` x and ``sb`` weight stages in flight."""
    bm: int
    bnw: int
    bn: int
    m_tiles: int
    n_tiles: int
    ntpb: int
    groups: int
    kc: int
    ra: int
    sx: int
    sb: int
    smem: int

    @property
    def grid(self) -> int:
        return self.m_tiles * self.groups


def smem_bytes(bm: int, bn: int, ra: int, sx: int, sb: int) -> int:
    """Dynamic shared memory of one block: the 1024-byte alignment slack, the
    panel (or ring) of int8 x chunks, the weight ring, the x ring (which the
    epilogue's staging reuses) and the mbarriers."""
    return (1024 + ra * bm * CHUNK + sb * bn * CHUNK + max(sx * bm * X_COLS * 4, STAGE_BYTES)
            + 16 * (sx + sb))


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int) -> QmmPlan:
    """The kernel's plan for an (M, K) x (K, N) call (the rules below come from
    a sweep of plans on an H100 at the 13 shapes of int8 ConvNeXt-T; PERF.md).

    - BM = 128 where x is wide against N (K >= 4 N) and the 128-row tiles alone
      fill the card: the two warpgroups share each weight tile.  Else BM = 64.
    - With 4 x 132 or more 64-row tiles, BNW = 32: small tiles, low registers
      and shared memory, two blocks per SM.  Otherwise the widest column tile
      of least padding among those whose grid can reach ``min(132, row tiles x
      column tiles at the narrowest width)`` blocks.
    - N is split over blocks only as far as the grid needs to reach 132
      blocks, or 264 (two waves) where each block then still walks two or more
      column tiles against its panel.  A block holds its whole int8 panel when
      it walks several column tiles; otherwise (or where the panel does not
      fit) a ring of 4 chunks.
    - Rings of 4 x and 3 weight stages, else 3 and 3.
    """
    Kp = -(-K // K_ALIGN) * K_ALIGN
    kc = -(-Kp // CHUNK)
    bm = 128 if K >= 4 * N and -(-M // 128) >= SMS else 64
    m_tiles = -(-M // bm)

    def width(bnw):
        return bnw if bm == 128 else 2 * bnw

    if bm == 64 and m_tiles >= 4 * SMS:
        bnw = 32
    else:
        target = min(SMS, m_tiles * -(-N // width(min(BNWS[bm]))))
        reach = [b for b in BNWS[bm] if m_tiles * -(-N // width(b)) >= target]
        bnw = min(reach, key=lambda b: (-(-N // width(b)) * width(b), -b))
    bn = width(bnw)
    n_tiles = -(-N // bn)
    ntpb = n_tiles // -(-2 * SMS // m_tiles)
    if ntpb < 2:
        ntpb = max(1, n_tiles // -(-SMS // m_tiles))
    for per_block in dict.fromkeys((ntpb, 1)):
        ra = kc if per_block > 1 else min(kc, 4)
        for sx, sb in ((4, 3), (3, 3)):
            smem = smem_bytes(bm, bn, ra, sx, sb)
            if smem <= SMEM_MAX:
                return QmmPlan(bm, bnw, bn, m_tiles, n_tiles, per_block,
                               -(-n_tiles // per_block), kc, ra, sx, sb, smem)
    raise ValueError(f"qmatmul: no shared-memory plan for (M, K, N) = {(M, K, N)}")


def pack_qweight(w_q: torch.Tensor) -> torch.Tensor:
    """The kernel's weight from an int8 (N, K) matrix (output features first):
    (N, Kp) contiguous, K zero-padded to a multiple of ``K_ALIGN``."""
    if w_q.dtype != torch.int8 or w_q.dim() != 2:
        raise ValueError(f"pack_qweight: need an int8 (N, K) matrix, got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    K = w_q.shape[1]
    return F.pad(w_q, (0, -K % K_ALIGN)).contiguous()


def quantize_activation(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric per-tensor int8 with a static scale: ``clip(round(x / scale))``."""
    return torch.clamp(torch.round(x.float() / scale), -INT8_MAX, INT8_MAX).to(torch.int8)


@in_float32
def qmatmul_ref(x, w_packed, a_scale, w_scale, bias=None):
    """Plain PyTorch version of :func:`qmatmul` on the same packed weight.  The
    int8 product runs in float64, exact while the sums stay below 2^53 (torch
    has no integer matrix product on the card), and is converted to float32
    once, as the int32 sum is.  A bfloat16 x is quantized from its exact
    float32 upcast and y is rounded to bfloat16 once, as the kernel does: the
    bits agree in both types."""
    K = x.shape[1]
    acc = quantize_activation(x, a_scale).double() @ w_packed[:, :K].double().t()
    y = acc.float() * (a_scale * w_scale)
    return y + bias if bias is not None else y


def _check(x, w_packed, a_scale, w_scale, bias):
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError(f"qmatmul: x must be (M, K) and w (N, Kp), got {tuple(x.shape)} "
                         f"and {tuple(w_packed.shape)}")
    M, K = x.shape
    N, Kp = w_packed.shape
    if Kp % K_ALIGN or not K <= Kp < K + K_ALIGN:
        raise ValueError(f"qmatmul: w must be packed by pack_qweight for K={K}, got Kp={Kp}")
    expected = {"a_scale": (), "w_scale": (N,), "bias": (N,)}
    tensors = {"x": x, "w": w_packed, "a_scale": a_scale, "w_scale": w_scale, "bias": bias}
    for name, t in tensors.items():
        if t is None:
            continue
        if name in expected and tuple(t.shape) != expected[name]:
            raise ValueError(f"qmatmul: {name} must be {expected[name]}, got {tuple(t.shape)}")
        if name == "x":
            check_x_type("qmatmul", x)
        elif t.dtype != (want := torch.int8 if name == "w" else torch.float32):
            raise TypeError(f"qmatmul: {name} must be {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"qmatmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"qmatmul: {name} must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("qmatmul.cu")
    for fn in (lib.qmatmul_f32, lib.qmatmul_bf16):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.qmatmul_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.qmatmul_smem_bytes.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def qmatmul(x, w_packed, a_scale, w_scale, bias: Optional[torch.Tensor] = None):
    """``f32(q(x) @ w_q^T) * (a_scale * w_scale) + bias``, quantizing x on the way in.

    x: (M, K) float32 or bfloat16, contiguous; w_packed: (N, Kp) int8 from
    :func:`pack_qweight`; a_scale: a 0-d float32 tensor on x's device (read
    there, no host sync); w_scale, bias: (N,) float32.  Returns (M, N) of x's
    type.
    Runs the custom op ``torch.ops.convnet_approximater_tpu_torch.qmatmul``.
    """
    check_device("qmatmul", x)
    return qmatmul_op(x, w_packed, a_scale, w_scale, bias)


qmatmul.launches = 0


@torch.library.custom_op(f"{NAMESPACE}::qmatmul", mutates_args=(), device_types="cpu")
def qmatmul_op(x: torch.Tensor, w_packed: torch.Tensor, a_scale: torch.Tensor,
               w_scale: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    _check(x, w_packed, a_scale, w_scale, bias)
    return qmatmul_ref(x, w_packed, a_scale, w_scale, bias).contiguous()


@qmatmul_op.register_kernel("cuda")
def _launch(x, w_packed, a_scale, w_scale, bias):
    _check(x, w_packed, a_scale, w_scale, bias)
    M, K = x.shape
    N, Kp = w_packed.shape
    if w_packed.data_ptr() % 16:
        raise ValueError("qmatmul: the packed weight must be 16-byte aligned")
    align = 16 // x.element_size()  # the x tensor map needs 16-byte rows: a padded copy
    if K % align or x.data_ptr() % 16:
        x = F.pad(x, (0, -K % align)) if K % align else x.clone()
    p = plan(M, K, N)
    y = x.new_empty((M, N))
    with torch.cuda.device(x.device), launch_range("qmatmul"):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(_library(), "qmatmul", x)(
            x.data_ptr(), w_packed.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(), M, x.shape[1], Kp, N,
            p.bm, p.bnw, p.ntpb, p.ra, p.sx, p.sb, stream)
    if err != 0:
        raise RuntimeError(f"qmatmul: CUDA launch failed with error {err}")
    qmatmul.launches += 1
    return y


@qmatmul_op.register_fake
def _fake(x, w_packed, a_scale, w_scale, bias):
    return x.new_empty((x.shape[0], w_packed.shape[0]))
