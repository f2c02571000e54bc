"""Fused activation quantize + int8 matrix product: CUDA kernel wrapper, its
plain PyTorch version, and the weight packing they share.

``qmatmul`` computes ``f32(q(x) @ w_q) * (a * w_scale) + bias`` with
``q(v) = clip(round(v / a), -127, 127)`` as int8 (round half to even) and an
exact integer sum, the int8 ``QuantLinear`` of the JAX package
(``convnet_approximater_tpu/layers/quant.py``) and its fused Pallas probe
``pallas_qmatmul`` (``scripts/exp_pallas_qmatmul.py``).  On a CUDA tensor it
launches ``csrc/qmatmul.cu`` (built with nvcc at first use) or raises; on a
CPU tensor it runs :func:`qmatmul_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .build import load

INT8_MAX = 127.0
K_ALIGN = 32  # the kernel's K step; the packed weight's rows are padded to it


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


def qmatmul_ref(x, w_packed, a_scale, w_scale, bias=None):
    """Plain PyTorch version of :func:`qmatmul` on the same packed weight.  The
    int8 product runs in float64, exact while the sums stay below 2^53 (torch
    has no integer matrix product on the card), and is converted to float32
    once, as the int32 sum is."""
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
        want = torch.int8 if name == "w" else torch.float32
        if t.dtype != want:
            raise TypeError(f"qmatmul: {name} must be {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"qmatmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"qmatmul: {name} must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("qmatmul.cu")
    fn = lib.qmatmul_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def qmatmul(x, w_packed, a_scale, w_scale, bias: Optional[torch.Tensor] = None):
    """``f32(q(x) @ w_q^T) * (a_scale * w_scale) + bias``, quantizing x on the way in.

    x: (M, K) float32, contiguous; w_packed: (N, Kp) int8 from
    :func:`pack_qweight`; a_scale: a 0-d float32 tensor on x's device (read
    there, no host sync); w_scale, bias: (N,) float32.  Returns (M, N) float32.
    """
    _check(x, w_packed, a_scale, w_scale, bias)
    if x.device.type == "cpu":
        return qmatmul_ref(x, w_packed, a_scale, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {x.device}")
    M, K = x.shape
    N, Kp = w_packed.shape
    if w_packed.data_ptr() % 16:
        raise ValueError("qmatmul: the packed weight must be 16-byte aligned")
    vec = int(K % 4 == 0 and x.data_ptr() % 16 == 0)
    y = x.new_empty((M, N))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().qmatmul_f32(
            x.data_ptr(), w_packed.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(), M, K, Kp, N, vec,
            stream)
    if err != 0:
        raise RuntimeError(f"qmatmul: CUDA launch failed with error {err}")
    qmatmul.launches += 1
    return y


qmatmul.launches = 0
