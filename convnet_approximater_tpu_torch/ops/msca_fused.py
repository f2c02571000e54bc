"""The fused MSCA block: CUDA kernel wrapper, its plain PyTorch version, and
the tap packing they share.

``msca_fused`` computes ``x * (Wm . fix(bank(dw_k0(x) + b0)) + bm)`` on an NHWC
map, the whole MSCA block of the JAX package's Pallas kernel of the same name
(``convnet_approximater_tpu/ops/pallas/msca_kernels.py``).  On a CUDA tensor it
launches ``csrc/msca_fused.cu`` (built with nvcc at first use) or raises; on a
CPU tensor it runs :func:`msca_fused_ref`.

The border fix follows ``FixPaddingBias`` (the module's semantics): the top
strip is added to rows ``[0, min(H, p))`` and the bottom strip, aligned to the
last row, to rows ``[H - min(H, p), H)``, both where the two overlap.  The
Pallas kernel's concatenated strip disagrees with that when ``H < 2 p``; this
port does not copy it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from .build import load

MAX_BRANCHES = 8  # kMaxBranches in csrc/msca_fused.cu


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


def msca_fused_ref(x, w0, b0, w1, b1, w2, b2, wm, bm, res=None, *,
                   ks: Sequence[int], identity: bool, fix_p: int):
    """Plain PyTorch version of :func:`msca_fused` on the same packed weights."""
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
    for name, t in tensors.items():
        if t.dtype != torch.float32:
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
    fn = lib.msca_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def msca_fused(x, w0, b0, w1, b1, w2, b2, wm, bm, res=None, *,
               ks: Sequence[int], identity: bool, fix_p: int):
    """Fused MSCA block ``x * (Wm . fix(bank(dw_k0(x) + b0)) + bm)``, NHWC.

    x: (B, H, W, C) float32, contiguous; w0: (k0, k0, C) depthwise taps;
    w1/w2: (nb, k_max, C) horizontal/vertical strip taps and b1/b2: (nb, C)
    from :func:`pack_cascade_weights`; wm: (C, C) channel mix, input dim
    first; bm, b0: (C,); res: (2, fix_p, C) border strips when ``fix_p > 0``.
    ``ks`` are the branches' true sizes; ``identity`` adds the conv0 output to
    the bank.  Returns a new (B, H, W, C) tensor.
    """
    _check(x, w0, b0, w1, b1, w2, b2, wm, bm, res, ks, fix_p)
    if x.device.type == "cpu":
        return msca_fused_ref(x, w0, b0, w1, b1, w2, b2, wm, bm, res,
                              ks=ks, identity=identity, fix_p=fix_p)
    if x.device.type != "cuda":
        raise ValueError(f"msca_fused: unsupported device {x.device}")
    B, H, W, C = x.shape
    nb, k_max = w1.shape[0], w1.shape[1]
    out = torch.empty_like(x)
    a0 = torch.empty_like(x)
    attn = torch.empty_like(x)
    t = x.new_empty((nb, B, H, W, C))
    ks_arr = (ctypes.c_int * nb)(*ks)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().msca_fused_f32(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), wm.data_ptr(), bm.data_ptr(),
            res.data_ptr() if fix_p > 0 else None,
            a0.data_ptr(), t.data_ptr(), attn.data_ptr(), out.data_ptr(),
            B, H, W, C, w0.shape[0], nb, k_max, ks_arr, int(identity), int(fix_p), stream)
    if err != 0:
        raise RuntimeError(f"msca_fused: CUDA launch failed with error {err}")
    msca_fused.launches += 1
    return out


msca_fused.launches = 0
