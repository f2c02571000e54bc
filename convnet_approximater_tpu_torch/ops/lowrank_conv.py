"""The scheme-1 low-rank conv: CUDA kernel wrapper, its plain PyTorch version,
the weight packing they share, and the kernel's planner.

``lowrank_conv`` computes ``LowRankExpConvV1`` on an NHWC map, as the JAX
package's Pallas kernel of the same name does
(``convnet_approximater_tpu/ops/pallas/lowrank_kernels.py``): M bases shared
by every input channel, as a separable pair (a kw-tap horizontal pass, then a
kh-tap vertical pass) or as full kh x kw filters, give Z (B, Ho, Wo, M, C);
then ``Z @ A_mc + b`` mixes it to N channels.  It is the custom op
``lowrank_conv_op``: on a CUDA tensor it launches ``csrc/lowrank_conv.cu``
(built with nvcc at first use), on a CPU tensor it runs
:func:`lowrank_conv_ref`, and on any other device the dispatcher raises.

The kernel is one launch and keeps Z out of device memory: producer warps
compute it from an x window in shared memory into a shared-memory ring, and
consumer warps mix it on the tensor cores in 3xTF32 with the packed weight
(:func:`pack_kernel_weights`: A^T's TF32 high and low parts in the kernel's K
order, and the bases as kh x kw taps).  :func:`plan` chooses its tiles for
each shape, in plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .build import NAMESPACE, check_device, launch_range, load

# the kernel's shared-memory plan (csrc/lowrank_conv.cu: smem_bytes) and the card's
SMS = 132               # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448      # dynamic shared memory one block may use
BM = 128                # output pixels of a tile
BNS = (128, 96, 64)     # the kernel's output-channel tiles
SLABS = (4, 6, 8)       # and its bases per slab
STAGE_BYTES = 8 * 16 * 40 * 4  # the epilogue's staging, which reuses the ring
CHAIN_STEPS = 16        # wgmma k-steps the tensor cores accumulate before the float32 sum


def out_size(H: int, W: int, kernel_size, stride, padding) -> Tuple[int, int]:
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    return (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1


def lowrank_params_from_module(module) -> dict:
    """The kernel's weights from a ``LowRankExpConvV1``, read from input
    channel 0's group: ``v`` (M, kh) and ``h`` (M, kw), or ``bases`` (M, kh, kw);
    ``A_mc`` (M*C, N), the mixing conv's rows permuted from the layer's
    ``c*M + m`` to the kernel's ``m*C + c``; ``b`` (N,)."""
    M, C = module.num_base, module.in_channels
    s = module.s_conv
    out = {}
    if hasattr(s, "v_conv"):
        out["v"] = s.v_conv.weight[:M, 0, :, 0].contiguous()
        out["h"] = s.h_conv.weight[:M, 0, 0, :].contiguous()
    else:
        out["bases"] = s.weight[:M, 0].contiguous()
    dw = module.d_conv.weight[:, :, 0, 0]  # (N, C*M)
    N = dw.shape[0]
    out["A_mc"] = dw.t().reshape(C, M, N).transpose(0, 1).reshape(M * C, N).contiguous()
    b = module.d_conv.bias
    out["b"] = b.contiguous() if b is not None else dw.new_zeros(N)
    return {k: t.detach() for k, t in out.items()}


def lowrank_conv_ref(x, A_mc, b, *, v=None, h=None, bases=None, kernel_size, stride=(1, 1),
                     padding=(0, 0)):
    """Plain PyTorch version of :func:`lowrank_conv`: grouped convs for the
    basis passes (horizontal first), then one matrix product for the mix."""
    B, H, W, C = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    xc = x.permute(0, 3, 1, 2)
    if bases is None:
        M = v.shape[0]
        t = F.conv2d(xc, h.repeat(C, 1).reshape(C * M, 1, 1, kw), stride=(1, sw),
                     padding=(0, pw), groups=C)
        zc = F.conv2d(t, v.repeat(C, 1).reshape(C * M, 1, kh, 1), stride=(sh, 1),
                      padding=(ph, 0), groups=C * M)
    else:
        M = bases.shape[0]
        zc = F.conv2d(xc, bases.repeat(C, 1, 1).reshape(C * M, 1, kh, kw), stride=(sh, sw),
                      padding=(ph, pw), groups=C)
    Ho, Wo = zc.shape[2:]
    # channel c*M + m of zc -> column m*C + c of the (B*Ho*Wo, M*C) map
    z = zc.reshape(B, C, M, Ho, Wo).permute(0, 3, 4, 2, 1).reshape(B * Ho * Wo, M * C)
    return torch.addmm(b, z, A_mc).reshape(B, Ho, Wo, -1)


def basis_slabs(M: int) -> Tuple[int, int]:
    """(MS, slabs): the kernel walks the M bases (padded to an even count) in
    slabs of MS in ``SLABS``, at most 8 a slab; Mp = MS x slabs >= M."""
    even = M + M % 2
    slabs = -(-even // SLABS[-1])
    return next(ms for ms in SLABS if ms * slabs >= even), slabs


def kernel_order(C: int, M: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input channel c and basis m of each K' column of the kernel's product
    (``c >= C`` or ``m >= M``: a zero pad).  K' walks channel quads, then slabs,
    then the slab's basis pairs, one wgmma k-step (8 columns) each; column q of
    a k-step is channel ``q // 2`` of the quad and basis ``q % 2`` of the pair,
    so the producer thread of a pixel and a channel pair writes its four
    columns of a k-step as one 16-byte piece."""
    ms, slabs = basis_slabs(M)
    k = torch.arange(4 * -(-C // 4) * ms * slabs, device=device)
    q, step = k % 8, k // 8
    pair, group = step % (ms // 2), step // (ms // 2)
    c = 4 * (group // slabs) + q // 2
    m = (group % slabs) * ms + 2 * pair + q % 2
    return c, m


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the bits of PTX ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000  # half an ulp onto the magnitude, then truncate
    special = (bits & 0x7F800000) == 0x7F800000  # inf and NaN keep their bits
    return torch.where(special, bits, rounded).view(torch.float32)


def pack_kernel_weights(A_mc, *, v=None, h=None, bases=None) -> dict:
    """The kernel's weight layout, packed once per weight version (``A_mc``,
    ``v``/``h`` or ``bases`` as :func:`lowrank_conv` takes them):

    - ``w`` (2, N, K'): A^T in :func:`kernel_order`, zero in the padding, split
      into TF32 high and low parts (``A ~= w[0] + w[1]`` to about 2^-21
      relative), K' contiguous: both operands of a TF32 wgmma are K-major;
    - ``taps`` (kh kw, Mp): tap (i, j) of basis m at row ``i kw + j``, the
      separable form expanded to its kh x kw outer product ``v[m] (x) h[m]``,
      the padded bases zero.
    """
    basis = bases if bases is not None else v[:, :, None] * h[:, None, :]
    M, kh, kw = basis.shape
    C, N = A_mc.shape[0] // M, A_mc.shape[1]
    ms, slabs = basis_slabs(M)
    taps = A_mc.new_zeros(kh * kw, ms * slabs)
    taps[:, :M] = basis.reshape(M, kh * kw).t()
    c, m = kernel_order(C, M, A_mc.device)
    valid = (c < C) & (m < M)
    at = torch.where(valid, A_mc[torch.where(valid, m * C + c, 0)].t(), 0.0)
    hi = tf32_round(at)
    return dict(w=torch.stack([hi, tf32_round(at - hi)]).contiguous(), taps=taps.contiguous())


class LowrankPlan(NamedTuple):
    """One launch: ``row_tiles`` x ``col_tiles`` blocks of BM pixels x ``bn``
    output channels; the bases in ``slabs`` slabs of ``ms``; x windows of
    ``qpg`` channel quads and ``rw`` rows of ``wv`` columns (row v of a tile's
    window is row ``vbase + v`` of x's B H rows, from the tile's first pixel's
    first tap row; columns from -pw), double-buffered; ``stages`` ring stages
    in flight; chains of ``chain`` groups (MS / 2 k-steps each) on the tensor
    cores between float32 sums; ``smem`` bytes of shared memory per block;
    ``cost`` the planner's estimate in SM cycles."""
    ms: int
    slabs: int
    bn: int
    qpg: int
    stages: int
    chain: int
    rw: int
    wv: int
    row_tiles: int
    col_tiles: int
    smem: int
    cost: float


def stage_bytes(ms: int, bn: int) -> int:
    """One ring stage: a group's Z (BM rows) and weight (bn rows), each as a
    TF32 high and a low part, in rows of 128 bytes (four k-steps; MS = 8 or 6)
    or 64 bytes (two; MS = 4)."""
    return 2 * (64 if ms == 4 else 128) * (BM + bn)


def smem_bytes(ms: int, bn: int, stages: int, qpg: int, rw: int, wv: int, ntaps: int,
               mp: int) -> int:
    """Dynamic shared memory of one block: the 1024-byte alignment slack, the
    ring, two x windows and a row of zeros (each 1024-byte aligned), the taps
    and the mbarriers."""
    row = 16 * qpg * wv
    return (1024 + stages * stage_bytes(ms, bn) + 2 * -(-rw * row // 1024) * 1024
            + -(-row // 1024) * 1024 + 16 * -(-ntaps * mp // 4) + 16 * stages + 32)


def window_row(p: torch.Tensor, Ho: int, Wo: int, H: int, sh: int, ph: int) -> torch.Tensor:
    """The first tap row of output pixel p (flattened over B, Ho, Wo) in x's
    stack of B H rows: ``b H + ho sh - ph`` (a tap row outside the pixel's
    image is padding, which the kernel reads from a row of zeros)."""
    return (p // (Ho * Wo)) * H + ((p % (Ho * Wo)) // Wo) * sh - ph


def _cost(blocks: int, groups: int, ms: int, bn: int, ntaps: int) -> float:
    """SM cycles of the kernel: full waves of blocks, each ``groups`` times its
    Z work (the producers' time for one group, about 150 cycles a tap and 80
    a basis on an H100) plus its tensor-core work (3 wgmma k-steps of 128 x bn
    x 8 at 1024 TF32 FMA a cycle, MS / 2 k-steps a group): the two overlap
    little (``ops/lowrank_conv_sweep.py``)."""
    return -(-blocks // SMS) * groups * (150 * ntaps + 80 * ms + 1.5 * ms * bn)


def _tiles(B: int, H: int, W: int, C: int, M: int, N: int, kernel_size, stride, padding,
           bn: int, chain: Optional[int] = None) -> Optional[LowrankPlan]:
    """The plan at output tile ``bn`` and ``chain`` groups a chain (or the
    rule's, see :func:`plan`); None where the window does not fit."""
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    Ho, Wo = out_size(H, W, kernel_size, stride, padding)
    wv = (Wo - 1) * sw + kw
    P = B * Ho * Wo
    row_tiles, col_tiles = -(-P // BM), -(-N // bn)
    first = torch.arange(0, P, BM, dtype=torch.int64)
    last = torch.clamp(first + BM, max=P) - 1
    rw = int((window_row(last, Ho, Wo, H, sh, ph) + kh - window_row(first, Ho, Wo, H, sh, ph))
             .max())
    ms, slabs = basis_slabs(M)
    quads, ntaps = -(-C // 4), kh * kw
    if chain is None:
        chain = max(1, CHAIN_STEPS // (ms // 2))
    qpgs = [q for q in (8, 4, 2, 1) if q <= quads]
    for stages in (4, 3, 2):
        fits = [q for q in qpgs if (stages == 2 or q >= min(2, quads))
                and smem_bytes(ms, bn, stages, q, rw, wv, ntaps, ms * slabs) <= SMEM_MAX]
        if fits:
            return LowrankPlan(ms, slabs, bn, fits[0], stages, chain, rw, wv, row_tiles,
                               col_tiles, smem_bytes(ms, bn, stages, fits[0], rw, wv, ntaps,
                                                     ms * slabs),
                               _cost(row_tiles * col_tiles, quads * slabs, ms, bn, ntaps))
    return None


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, C: int, M: int, N: int, kernel_size, stride,
         padding) -> LowrankPlan:
    """The kernel's plan for one call.

    - ``bn``: the tile of least estimated time (:func:`_cost`: padding N to a
      multiple of bn counts, and each column tile recomputes the Z it mixes);
      of equal estimates the one of least padding, then the widest.
    - ``chain``: CHAIN_STEPS k-steps (at least one group) between float32 sums.
    - The window rows ``rw``: the most rows of x's stack any BM-pixel tile's
      taps span (a tile that crosses an image boundary spans the bottom of one
      image and the top of the next).
    - Four ring stages (one group each) if they fit beside a window of two or
      more quads, else three, else two; then the widest window of 8, 4, 2 or 1
      quads that fits.
    """
    plans = [p for bn in BNS if (p := _tiles(B, H, W, C, M, N, kernel_size, stride,
                                               padding, bn)) is not None]
    if not plans:
        raise ValueError(f"lowrank_conv: no shared-memory plan for x {(B, H, W, C)}, "
                         f"kernel {kernel_size}, stride {stride}: its x window does not fit")
    return min(plans, key=lambda p: (p.cost, p.col_tiles * p.bn, -p.bn))


def _check(x, A_mc, b, v, h, bases, kernel_size, stride, padding):
    if x.dim() != 4:
        raise ValueError(f"lowrank_conv: x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    kh, kw = kernel_size
    if bases is None and (v is None or h is None):
        raise ValueError("lowrank_conv: pass v and h, or bases")
    if bases is not None and (v is not None or h is not None):
        raise ValueError("lowrank_conv: pass v and h, or bases, not both")
    M = v.shape[0] if bases is None else bases.shape[0]
    N = A_mc.shape[-1]
    expected = {"A_mc": (M * C, N), "b": (N,)}
    tensors = {"x": x, "A_mc": A_mc, "b": b}
    if bases is None:
        expected.update(v=(M, kh), h=(M, kw))
        tensors.update(v=v, h=h)
    else:
        expected["bases"] = (M, kh, kw)
        tensors["bases"] = bases
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"lowrank_conv: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"lowrank_conv: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lowrank_conv: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lowrank_conv: {name} must be contiguous")
    if min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"lowrank_conv: bad stride {stride} or padding {padding}")
    Ho, Wo = out_size(H, W, kernel_size, stride, padding)
    if min(B, C, M, N, Ho, Wo) < 1:
        raise ValueError(f"lowrank_conv: empty problem (B={B}, C={C}, M={M}, N={N}, "
                         f"Ho={Ho}, Wo={Wo})")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("lowrank_conv.cu")
    fn = lib.lowrank_conv_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lowrank_conv_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.lowrank_conv_smem_bytes.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def lowrank_conv(x, A_mc, b, *, v=None, h=None, bases=None, kernel_size, stride=(1, 1),
                 padding=(0, 0), packed: Optional[dict] = None):
    """Scheme-1 conv on an NHWC map.

    x: (B, H, W, C) float32, contiguous; either ``v`` (M, kh) + ``h`` (M, kw)
    separable taps or ``bases`` (M, kh, kw) full filters; ``A_mc`` (M*C, N)
    mixing matrix with rows ordered ``m*C + c``; b: (N,).  ``kernel_size``,
    ``stride`` and ``padding`` are (h, w) pairs.  ``packed``: the kernel's
    layout of these weights (:func:`pack_kernel_weights`), which a caller that
    runs them again keeps; without it a CUDA call packs them first.  Returns a
    new (B, Ho, Wo, N) tensor.  Runs the custom op
    ``torch.ops.convnet_approximater_tpu_torch.lowrank_conv``.
    """
    check_device("lowrank_conv", x)
    packed = packed or {}
    return lowrank_conv_op(x, A_mc, b, v, h, bases, packed.get("w"), packed.get("taps"),
                           [int(k) for k in kernel_size], [int(s) for s in stride],
                           [int(p) for p in padding])


lowrank_conv.launches = 0


@torch.library.custom_op(f"{NAMESPACE}::lowrank_conv", mutates_args=(), device_types="cpu")
def lowrank_conv_op(x: torch.Tensor, A_mc: torch.Tensor, b: torch.Tensor,
                    v: Optional[torch.Tensor], h: Optional[torch.Tensor],
                    bases: Optional[torch.Tensor], w: Optional[torch.Tensor],
                    taps: Optional[torch.Tensor], kernel_size: List[int], stride: List[int],
                    padding: List[int]) -> torch.Tensor:
    """The op: ``w`` and ``taps`` are the packed layout the CUDA kernel reads
    (None: packed on the way in); the CPU's plain version reads the rest."""
    kernel_size, stride, padding = tuple(kernel_size), tuple(stride), tuple(padding)
    _check(x, A_mc, b, v, h, bases, kernel_size, stride, padding)
    return lowrank_conv_ref(x, A_mc, b, v=v, h=h, bases=bases, kernel_size=kernel_size,
                            stride=stride, padding=padding).contiguous()


@lowrank_conv_op.register_kernel("cuda")
def _launch(x, A_mc, b, v, h, bases, w, taps, kernel_size, stride, padding):
    kernel_size, stride, padding = tuple(kernel_size), tuple(stride), tuple(padding)
    _check(x, A_mc, b, v, h, bases, kernel_size, stride, padding)
    B, H, W, C = x.shape
    M = v.shape[0] if bases is None else bases.shape[0]
    N = A_mc.shape[1]
    if w is None or taps is None:
        packed = pack_kernel_weights(A_mc, v=v, h=h, bases=bases)
        w, taps = packed["w"], packed["taps"]
    p = plan(B, H, W, C, M, N, kernel_size, stride, padding)
    kp = 4 * -(-C // 4) * p.ms * p.slabs
    for name, t, shape in (("w", w, (2, N, kp)),
                           ("taps", taps, (kernel_size[0] * kernel_size[1], p.ms * p.slabs))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"lowrank_conv: packed {name} must be a contiguous float32 {shape} "
                             f"on {x.device} (pack_kernel_weights), got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    Ho, Wo = out_size(H, W, kernel_size, stride, padding)
    y = x.new_empty((B, Ho, Wo, N))
    with torch.cuda.device(x.device), launch_range("lowrank_conv"):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().lowrank_conv_f32(
            x.data_ptr(), w.data_ptr(), taps.data_ptr(), b.data_ptr(), y.data_ptr(),
            B, H, W, C, N, p.ms, p.slabs, *kernel_size, *stride, *padding, p.bn, p.qpg, p.rw,
            p.stages, p.chain, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_conv: CUDA launch failed with error {err}")
    lowrank_conv.launches += 1
    return y


@lowrank_conv_op.register_fake
def _fake(x, A_mc, b, v, h, bases, w, taps, kernel_size, stride, padding):
    B, H, W = x.shape[0], x.shape[1], x.shape[2]
    Ho, Wo = out_size(H, W, kernel_size, stride, padding)
    return x.new_empty((B, Ho, Wo, A_mc.shape[1]))
