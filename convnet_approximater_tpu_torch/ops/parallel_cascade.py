"""The strip-conv bank alone: CUDA kernel wrapper and its plain PyTorch version.

``parallel_cascade`` computes ``sum_br vconv_k(hconv_k(x) + b1) + b2 [+ x]`` on
an NHWC map, as the JAX package's Pallas kernel of the same name does
(``convnet_approximater_tpu/ops/pallas/msca_kernels.py``), on the taps packed
by :func:`~convnet_approximater_tpu_torch.ops.msca_fused.pack_cascade_weights`.
It is the custom op ``parallel_cascade_op``: on a CUDA tensor it launches
``csrc/parallel_cascade.cu`` (built with nvcc at first use), on a CPU tensor it
runs :func:`parallel_cascade_ref`, and on any other device the dispatcher
raises.

The kernel is one launch per call that keeps the horizontal result on chip
(in registers when every branch has k = k_max, else in a ring of k_max rows
per branch in shared memory), so the wrapper allocates only the output.  The
ring sets the ceiling ``nb * k_max <= MAX_BANK_ROWS``: :func:`parallel_cascade`
raises beyond it, on every device, and the strip-bank layers send such a bank
to their module path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F

from .build import NAMESPACE, check_device, launch_range, load
from .msca_fused import MAX_BRANCHES

MAX_BANK_ROWS = 128  # kMaxBankRows in csrc/parallel_cascade.cu: nb * k_max


def parallel_cascade_ref(x, w1, b1, w2, b2, *, ks: Sequence[int], identity: bool):
    """Plain PyTorch version of :func:`parallel_cascade` on the same packed weights.

    It adds the terms in the kernel's order, one rounding per product and per
    sum: per branch the horizontal pass starts at b1 and adds its taps left
    to right on the zero-padded map, the vertical pass starts at b2 and adds
    its taps top to bottom on the horizontal result padded with zero rows (so
    rows outside the map hold 0, not b1), and the branches add to x (identity)
    or to 0 in order.  On the card it therefore gives the kernel's bits.
    """
    B, H, W, C = x.shape
    k_max = w1.shape[1]
    out = x if identity else torch.zeros_like(x)
    for br, k in enumerate(ks):
        off, p = (k_max - k) // 2, k // 2
        xp = F.pad(x, (0, 0, p, p))  # zero columns left and right
        t = b1[br].expand(B, H, W, C)
        for j in range(k):
            t = t + w1[br, off + j] * xp[:, :, j:j + W]
        tp = F.pad(t, (0, 0, 0, 0, p, p))  # zero rows above and below
        s = b2[br].expand(B, H, W, C)
        for i in range(k):
            s = s + w2[br, off + i] * tp[:, i:i + H]
        out = out + s
    return out


def _check(x, w1, b1, w2, b2, ks):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    C = x.shape[3]
    nb, k_max = w1.shape[0], w1.shape[1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    expected = {"w1": (nb, k_max, C), "b1": (nb, C), "w2": (nb, k_max, C), "b2": (nb, C)}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"parallel_cascade: {name} must be {shape}, "
                             f"got {tuple(tensors[name].shape)}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"parallel_cascade: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"parallel_cascade: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"parallel_cascade: {name} must be contiguous")
    if not 1 <= nb <= MAX_BRANCHES or len(ks) != nb:
        raise ValueError(f"parallel_cascade: need 1..{MAX_BRANCHES} branches and one k each, "
                         f"got nb={nb}, ks={tuple(ks)}")
    if nb * k_max > MAX_BANK_ROWS:
        raise ValueError(f"parallel_cascade: nb * k_max = {nb} * {k_max} exceeds the kernel's "
                         f"ring of {MAX_BANK_ROWS} rows")
    for k in ks:
        if k % 2 == 0 or not 1 <= k <= k_max or (k_max - k) % 2:
            raise ValueError(f"parallel_cascade: branch size {k} must be odd and <= {k_max}, "
                             f"centred in the packed taps")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("parallel_cascade.cu")
    fn = lib.parallel_cascade_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def parallel_cascade(x, w1, b1, w2, b2, *, ks: Sequence[int], identity: bool):
    """Strip-conv bank ``sum_br vconv_k(hconv_k(x) + b1) + b2 [+ x]``, NHWC.

    x: (B, H, W, C) float32, contiguous; w1/w2: (nb, k_max, C) horizontal/
    vertical taps and b1/b2: (nb, C), from ``pack_cascade_weights``; ``ks``
    the branches' true (odd) sizes, each padded by k // 2; ``identity`` adds
    x.  Returns a new (B, H, W, C) tensor.  Runs the custom op
    ``torch.ops.convnet_approximater_tpu_torch.parallel_cascade``.
    """
    check_device("parallel_cascade", x)
    return parallel_cascade_op(x, w1, b1, w2, b2, [int(k) for k in ks], bool(identity))


parallel_cascade.launches = 0


@torch.library.custom_op(f"{NAMESPACE}::parallel_cascade", mutates_args=(), device_types="cpu")
def parallel_cascade_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, ks: List[int], identity: bool) -> torch.Tensor:
    _check(x, w1, b1, w2, b2, ks)
    return parallel_cascade_ref(x, w1, b1, w2, b2, ks=ks, identity=identity).contiguous()


@parallel_cascade_op.register_kernel("cuda")
def _launch(x, w1, b1, w2, b2, ks, identity):
    _check(x, w1, b1, w2, b2, ks)
    B, H, W, C = x.shape
    nb, k_max = w1.shape[0], w1.shape[1]
    out = torch.empty_like(x)
    ks_arr = (ctypes.c_int * nb)(*ks)
    with torch.cuda.device(x.device), launch_range("parallel_cascade"):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().parallel_cascade_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), B, H, W, C, nb, k_max, ks_arr, int(identity), stream)
    if err != 0:
        raise RuntimeError(f"parallel_cascade: CUDA launch failed with error {err}")
    parallel_cascade.launches += 1
    return out


@parallel_cascade_op.register_fake
def _fake(x, w1, b1, w2, b2, ks, identity):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
