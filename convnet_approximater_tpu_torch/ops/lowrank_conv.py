"""The scheme-1 low-rank conv: CUDA kernel wrapper, its plain PyTorch version,
and the weight packing they share.

``lowrank_conv`` computes ``LowRankExpConvV1`` on an NHWC map, as the JAX
package's Pallas kernel of the same name does
(``convnet_approximater_tpu/ops/pallas/lowrank_kernels.py``): M bases shared
by every input channel, as a separable pair (a kw-tap horizontal pass, then a
kh-tap vertical pass) or as full kh x kw filters, give Z (B, Ho, Wo, M, C);
then ``Z @ A_mc + b`` mixes it to N channels.  On a CUDA tensor it launches
``csrc/lowrank_conv.cu`` (built with nvcc at first use) or raises; on a CPU
tensor it runs :func:`lowrank_conv_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import load


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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the CUDA kernel now rather than at its first launch."""
    _library()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def lowrank_conv(x, A_mc, b, *, v=None, h=None, bases=None, kernel_size, stride=(1, 1),
                 padding=(0, 0)):
    """Scheme-1 conv on an NHWC map.

    x: (B, H, W, C) float32, contiguous; either ``v`` (M, kh) + ``h`` (M, kw)
    separable taps or ``bases`` (M, kh, kw) full filters; ``A_mc`` (M*C, N)
    mixing matrix with rows ordered ``m*C + c``; b: (N,).  ``kernel_size``,
    ``stride`` and ``padding`` are (h, w) pairs.  Returns a new (B, Ho, Wo, N)
    tensor.
    """
    kernel_size, stride, padding = tuple(kernel_size), tuple(stride), tuple(padding)
    _check(x, A_mc, b, v, h, bases, kernel_size, stride, padding)
    if x.device.type == "cpu":
        return lowrank_conv_ref(x, A_mc, b, v=v, h=h, bases=bases, kernel_size=kernel_size,
                                stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"lowrank_conv: unsupported device {x.device}")
    B, H, W, C = x.shape
    M = v.shape[0] if bases is None else bases.shape[0]
    N = A_mc.shape[1]
    Ho, Wo = out_size(H, W, kernel_size, stride, padding)
    z = x.new_empty((B, Ho, Wo, M, C))
    y = x.new_empty((B, Ho, Wo, N))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().lowrank_conv_f32(
            x.data_ptr(), _ptr(v), _ptr(h), _ptr(bases), A_mc.data_ptr(), b.data_ptr(),
            z.data_ptr(), y.data_ptr(), B, H, W, C, M, N, *kernel_size, *stride, *padding,
            stream)
    if err != 0:
        raise RuntimeError(f"lowrank_conv: CUDA launch failed with error {err}")
    lowrank_conv.launches += 1
    return y


lowrank_conv.launches = 0
