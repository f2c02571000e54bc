"""The fused MSCA block: CUDA kernel wrapper, its plain PyTorch version, and
the tap packing they share.

``msca_fused`` computes ``x * (Wm . fix(bank(dw_k0(x) + b0)) + bm)`` on an NHWC
map, the whole MSCA block of the JAX package's Pallas kernel of the same name
(``convnet_approximater_tpu/ops/pallas/msca_kernels.py``).  It is the custom op
``msca_fused_op``: on a CUDA tensor it launches ``csrc/msca_fused.cu`` (built
with nvcc at first use), on a CPU tensor it runs :func:`msca_fused_ref`, and on
any other device the dispatcher raises.  The kernel is two launches: a row
march that keeps conv0's output and the strip bank's horizontal pass on chip and
writes the block's attention map, then the channel mix with the gate.
:func:`plan` chooses the march's tiles and bands for each shape, in plain
Python, so the CPU tests reach it.

The border fix follows ``FixPaddingBias`` (the module's semantics): the top
strip is added to rows ``[0, min(H, p))`` and the bottom strip, aligned to the
last row, to rows ``[H - min(H, p), H)``, both where the two overlap.  The
Pallas kernel's concatenated strip disagrees with that when ``H < 2 p``; this
port does not copy it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from .build import NAMESPACE, check_device, check_x_type, entry, in_float32, launch_range, load

MAX_BRANCHES = 8  # kMaxBranches in csrc/msca_fused.cu

# the march kernels' shared-memory plans (csrc/msca_fused.cu: smem_bytes) and the card's
SMS = 132               # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448      # dynamic shared memory one block may use
LANES = 32              # channels per block, one per lane
MAX_WARPS = 8           # kMaxWarps
RUN = 8                 # kRun: conv0 columns per thread and run
AHEAD = 4               # kAhead: x rows in flight
# march_kernel<21, 5, 4> (K, k0, G: output columns per thread) takes MSCAN-t's blocks, conv0 of
# 5 taps and banks of 21; march_any_kernel every other odd k0 and bank (K = k_max, G = 1, at
# most ANY_COLS columns per tile)
FAST_K, FAST_K0, FAST_G = 21, 5, 4
ANY_COLS = 32


class MscaPlan(NamedTuple):
    """One call's tiling: the march runs ``blocks`` = B x ``nchunks`` (32
    channels each) x ``ntiles`` (``tw`` columns each, ``warps`` warps) x
    ``bands`` (``rows`` rows each) blocks at K taps, ``g`` columns per thread
    (``FAST_G``: march_kernel; 1: march_any_kernel); ``halo`` rows (and
    columns) of x beyond its band each block reads; ``smem`` bytes of shared
    memory per block; the mix takes 128 pixels x ``mix_tn`` output channels per
    block."""
    K: int
    g: int
    warps: int
    tw: int
    ntiles: int
    nchunks: int
    rows: int
    bands: int
    blocks: int
    halo: int
    smem: int
    mix_tn: int
    launches: int = 2


def smem_bytes(K: int, k0: int, nb: int, g: int, warps: int, tw: int) -> int:
    """Shared memory of one march block, each row 32 channels wide.
    march_kernel: the taps (wh, wv, b1, w0), one a0 row and a ring of k0 + AHEAD
    x rows; march_any_kernel: the taps (wh, wv, b1), one a0 row and K rows of
    running sums."""
    if g == FAST_G:
        aw = -(-(warps * g + K - 1) // RUN) * RUN
        return 4 * LANES * (2 * nb * K + nb + k0 * k0 + aw + (k0 + AHEAD) * (aw + k0 - 1))
    return 4 * LANES * (2 * nb * K + nb + tw + K - 1 + K * tw)


def _tiles(B: int, H: int, W: int, C: int, k0: int, ks: tuple, fast: bool,
           bands: Optional[int] = None) -> Optional[MscaPlan]:
    """The plan of march_kernel (``fast``) or march_any_kernel for one call, at
    ``bands`` bands or the rule's (see :func:`plan`); None where it does not fit."""
    nb = len(ks)
    if fast:
        K, g = FAST_K, FAST_G
        ntiles = -(-W // (MAX_WARPS * g))
        tw = -(-W // ntiles)
        warps = -(-tw // g)
    else:
        K, g = max(ks), 1
        cols = min(ANY_COLS, (SMEM_MAX // (4 * LANES) - 2 * nb * K - nb - K + 1) // (K + 1))
        if cols < 1:
            return None
        ntiles = -(-W // cols)
        tw = -(-W // ntiles)
        warps = min(MAX_WARPS, tw)
    nchunks = -(-C // LANES)
    smem = smem_bytes(K, k0, nb, g, warps, tw)
    if smem > SMEM_MAX:
        return None
    base = B * nchunks * ntiles
    if bands is None:
        bands = 1
        while base * bands < SMS // 2 and -(-H // (bands + 1)) >= K // 2:
            bands += 1
    rows = -(-H // bands)
    bands = -(-H // rows)
    return MscaPlan(K, g, warps, tw, ntiles, nchunks, rows, bands, base * bands,
                    K // 2 + k0 // 2, smem, 64 if C % 64 == 0 else 32)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, C: int, k0: int, ks: tuple) -> Optional[MscaPlan]:
    """The kernel's plan for one call, or None where no shared-memory plan takes
    the bank (none that ``packed()`` admits: nb <= 8, nb k_max <= 128).

    The rules come from ``ops/msca_fused_sweep.py`` on an H100 at MSCAN-t's
    shapes (PERF.md):
    - Kernel: march_kernel<21, 5, 4> where k0 = 5 and k_max = 21 (MSCAN-t's
      banks), else march_any_kernel.
    - Columns: tiles of at most 8 G columns (march_kernel) or ANY_COLS columns
      within shared memory (march_any_kernel), split evenly over W.
    - Bands: one, unless the grid is short of SMS // 2 blocks (a small
      batch): then the rows split while it stays short and a band keeps K // 2
      rows.  A band recomputes up to K // 2 + k0 // 2 rows of halo at each
      edge; at b=64 one band was the fastest at every shape.
    """
    return _tiles(B, H, W, C, k0, tuple(ks), k0 == FAST_K0 and max(ks) == FAST_K)


def pack_cascade_weights(w1_list, b1_list, w2_list, b2_list):
    """Stack per-branch strip taps into (nb, k_max, C) arrays.

    ``w1_list[i]``: horizontal taps (k_i, C); ``w2_list[i]``: vertical taps
    (k_i, C); biases (C,) or None.  Shorter branches are zero-embedded at the
    centre of k_max taps (exact under zero padding).  Returns
    ``(w1, b1, w2, b2, ks)`` with ``ks`` the tuple of true kernel sizes.
    """
    ks = tuple(int(w.shape[0]) for w in w1_list)
    k_max = max(ks)
    nb, C = len(w1_list), w1_list[0].shape[-1]
    kw = dict(dtype=torch.float32, device=w1_list[0].device)
    w1, w2 = torch.zeros(nb, k_max, C, **kw), torch.zeros(nb, k_max, C, **kw)
    b1, b2 = torch.zeros(nb, C, **kw), torch.zeros(nb, C, **kw)
    for i, (wa, wb) in enumerate(zip(w1_list, w2_list)):
        off = (k_max - wa.shape[0]) // 2
        w1[i, off:off + wa.shape[0]] = wa
        off = (k_max - wb.shape[0]) // 2
        w2[i, off:off + wb.shape[0]] = wb
        if b1_list[i] is not None:
            b1[i] = b1_list[i]
        if b2_list[i] is not None:
            b2[i] = b2_list[i]
    return w1, b1, w2, b2, ks


def fix_strip(res: torch.Tensor, H: int) -> torch.Tensor:
    """(H, C) border residual of ``FixPaddingBias`` from ``res`` (2, p, C)."""
    p = res.shape[1]
    p2 = min(H, p)
    strip = res.new_zeros(H, res.shape[2])
    strip[:p2] += res[0, :p2]
    strip[H - p2:] += res[1, p - p2:]
    return strip


@in_float32
def msca_fused_ref(x, w0, b0, w1, b1, w2, b2, wm, bm, res=None, *,
                   ks: Sequence[int], identity: bool, fix_p: int):
    """Plain PyTorch version of :func:`msca_fused` on the same packed weights
    (a bfloat16 x: in float32 on its exact upcast, the result rounded once)."""
    B, H, W, C = x.shape
    k0 = w0.shape[0]
    k_max = w1.shape[1]
    xc = x.permute(0, 3, 1, 2)
    a0 = F.conv2d(xc, w0.permute(2, 0, 1).unsqueeze(1), b0, padding=k0 // 2, groups=C)
    attn = a0 if identity else torch.zeros_like(a0)
    for br, k in enumerate(ks):
        off = (k_max - k) // 2
        wh = w1[br, off:off + k].t().reshape(C, 1, 1, k)
        wv = w2[br, off:off + k].t().reshape(C, 1, k, 1)
        t = F.conv2d(a0, wh, b1[br], padding=(0, k // 2), groups=C)
        attn = attn + F.conv2d(t, wv, b2[br], padding=(k // 2, 0), groups=C)
    if fix_p > 0:
        attn = attn + fix_strip(res, H).t()[None, :, :, None]
    mixed = F.conv2d(attn, wm.t()[:, :, None, None], bm)
    return (xc * mixed).permute(0, 2, 3, 1)


def _check(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks, fix_p):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    nb, k_max = w1.shape[0], w1.shape[1]
    k0 = w0.shape[0]
    expected = {"w0": (k0, k0, C), "b0": (C,), "w1": (nb, k_max, C), "b1": (nb, C),
                "w2": (nb, k_max, C), "b2": (nb, C), "wm": (C, C), "bm": (C,)}
    tensors = {"x": x, "w0": w0, "b0": b0, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
               "wm": wm, "bm": bm}
    if fix_p > 0:
        expected["res"] = (2, fix_p, C)
        tensors["res"] = res
    for name, shape in expected.items():
        if tensors[name] is None or tuple(tensors[name].shape) != shape:
            got = None if tensors[name] is None else tuple(tensors[name].shape)
            raise ValueError(f"msca_fused: {name} must be {shape}, got {got}")
    check_x_type("msca_fused", x)
    for name, t in tensors.items():
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"msca_fused: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"msca_fused: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"msca_fused: {name} must be contiguous")
    if k0 % 2 == 0 or k_max % 2 == 0:
        raise ValueError(f"msca_fused: kernel sizes must be odd (k0={k0}, k_max={k_max})")
    if not 1 <= nb <= MAX_BRANCHES or len(ks) != nb:
        raise ValueError(f"msca_fused: need 1..{MAX_BRANCHES} branches and one k each, "
                         f"got nb={nb}, ks={tuple(ks)}")
    for k in ks:
        if k % 2 == 0 or not 1 <= k <= k_max:
            raise ValueError(f"msca_fused: branch size {k} must be odd and <= {k_max}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("msca_fused.cu")
    for fn in (lib.msca_fused_f32, lib.msca_fused_bf16):
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.msca_fused_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.msca_fused_smem_bytes.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def msca_fused(x, w0, b0, w1, b1, w2, b2, wm, bm, res=None, *,
               ks: Sequence[int], identity: bool, fix_p: int):
    """Fused MSCA block ``x * (Wm . fix(bank(dw_k0(x) + b0)) + bm)``, NHWC.

    x: (B, H, W, C) float32 or bfloat16, contiguous; the weights float32:
    w0: (k0, k0, C) depthwise taps;
    w1/w2: (nb, k_max, C) horizontal/vertical strip taps and b1/b2: (nb, C)
    from :func:`pack_cascade_weights`; wm: (C, C) channel mix, input dim
    first; bm, b0: (C,); res: (2, fix_p, C) border strips when ``fix_p > 0``.
    ``ks`` are the branches' true sizes; ``identity`` adds the conv0 output to
    the bank.  Returns a new (B, H, W, C) tensor of x's type.  Runs the custom op
    ``torch.ops.convnet_approximater_tpu_torch.msca_fused``.
    """
    check_device("msca_fused", x)
    return msca_fused_op(x, w0, b0, w1, b1, w2, b2, wm, bm, res, [int(k) for k in ks],
                         bool(identity), int(fix_p))


msca_fused.launches = 0


@torch.library.custom_op(f"{NAMESPACE}::msca_fused", mutates_args=(), device_types="cpu")
def msca_fused_op(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, wm: torch.Tensor,
                  bm: torch.Tensor, res: Optional[torch.Tensor], ks: List[int], identity: bool,
                  fix_p: int) -> torch.Tensor:
    _check(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks, fix_p)
    return msca_fused_ref(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks=ks, identity=identity,
                          fix_p=fix_p).contiguous()


@msca_fused_op.register_kernel("cuda")
def _launch(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks, identity, fix_p):
    _check(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks, fix_p)
    B, H, W, C = x.shape
    k0, nb, k_max = w0.shape[0], w1.shape[0], w1.shape[1]
    p = plan(B, H, W, C, k0, tuple(ks))
    if p is None:
        raise ValueError(f"msca_fused: no kernel plan for k0={k0}, ks={tuple(ks)}")
    out = torch.empty_like(x)
    attn = torch.empty_like(x, dtype=torch.float32)  # the march's output, the mix's input
    with torch.cuda.device(x.device), launch_range("msca_fused"):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(_library(), "msca_fused", x)(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), wm.data_ptr(), bm.data_ptr(),
            res.data_ptr() if fix_p > 0 else None, attn.data_ptr(), out.data_ptr(),
            B, H, W, C, k0, nb, k_max, int(identity), int(fix_p),
            p.K, p.g, p.warps, p.tw, p.ntiles, p.rows, p.bands, p.mix_tn, stream)
    if err != 0:
        raise RuntimeError(f"msca_fused: CUDA launch failed with error {err}")
    msca_fused.launches += 1
    return out


@msca_fused_op.register_fake
def _fake(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks, identity, fix_p):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
