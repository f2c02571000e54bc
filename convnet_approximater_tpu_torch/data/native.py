"""ctypes binding of the host batch preparation library (port of
``convnet_approximater_tpu/data/native.py``).

``_native/batch_prep.cpp`` gathers a batch from a uint8 (N, H, W, C) image
pool at given indices, crops and flips it by :func:`~.loader.draw_aug_params`'s
draws (reflecting at the borders) and nearest-resizes it, in a few threads per
call that run without the GIL (``ctypes.CDLL`` releases it for the call):

* :func:`gather_batch` / :func:`gather_batch_aug` write uint8, the batch the
  ``Loader`` ships and normalizes on the card;
* :func:`prep_batch` / :func:`prep_batch_aug` (the JAX module's functions)
  write float32 normalized on the host as ``x * (1 / std) + (-mean / std)``,
  the JAX library's arithmetic bit for bit (``serve``'s host-normalizing
  loader).

Each function writes into ``out`` when given one (a pinned tensor's numpy
view, say) and returns the batch.  The library is built with g++ at first use
into ``build/native/`` at the repository root, named by a hash of the source
and the flags.  Where the JAX module gives way to numpy when the library
cannot be built or called, this one raises, with the compiler's output: the
numpy path runs only when a caller asks for it (``Loader(native=False)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "_native" / "batch_prep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
# the JAX library's flags (no -march=native, so no FMA contraction on x86-64), C++17 for
# `if constexpr`, and no contraction where a host's base instruction set has FMA
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
MAX_THREADS = 8

_u8, _i64, _f32 = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int64, ctypes.c_float))
_GEOMETRY = [_u8, _i64] + [ctypes.c_int] * 6  # images, indices, n, H, W, C, th, tw
_AUG = [_i64, _i64, _i64, _i64, _u8]           # y0, x0, ch, cw, flip
_SIGNATURES = {
    "cat_prep_batch": _GEOMETRY + [_f32, _f32, _f32, ctypes.c_int],
    "cat_prep_batch_aug": _GEOMETRY + [_f32, _f32] + _AUG + [_f32, ctypes.c_int],
    "cat_gather_batch": _GEOMETRY + [_u8, ctypes.c_int],
    "cat_gather_batch_aug": _GEOMETRY + _AUG + [_u8, ctypes.c_int],
}


def library_path() -> Path:
    """The shared library, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbatch_prep-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raise with the
    compiler's output when it cannot be built."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # then renamed: concurrent builds are safe
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native batch prep: cannot run {CXX} ({e}); the Loader's numpy "
                           f"path is Loader(native=False)") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native batch prep: {' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, its four entry points declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def default_threads() -> int:
    """Threads per call: the process's intra-op budget (``torch.get_num_threads``), at most 8."""
    return max(1, min(MAX_THREADS, torch.get_num_threads()))


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check_pool(images: np.ndarray, indices) -> np.ndarray:
    if not isinstance(images, np.ndarray) or images.dtype != np.uint8 or images.ndim != 4:
        raise TypeError(f"native batch prep: images must be a uint8 (N, H, W, C) array, got "
                        f"{getattr(images, 'dtype', type(images))} of shape "
                        f"{np.shape(images)}")
    if not images.flags.c_contiguous:
        raise ValueError("native batch prep: images must be C-contiguous")
    indices = np.ascontiguousarray(indices, np.int64)
    if indices.ndim != 1:
        raise ValueError(f"native batch prep: indices must be 1-d, got {indices.shape}")
    if len(indices) and (indices.min() < 0 or indices.max() >= len(images)):
        raise IndexError(f"native batch prep: an index lies outside the pool's "
                         f"{len(images)} images")
    return indices


def _out(out: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != tuple(shape) or out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError(f"native batch prep: out must be a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {tuple(shape)}, got {out.dtype} {out.shape}")
    return out


def _aug_args(params, n: int) -> list:
    y0, x0, ch, cw, flip = params
    arrays = [np.ascontiguousarray(a, np.int64) for a in (y0, x0, ch, cw)]
    arrays.append(np.ascontiguousarray(flip, np.uint8))
    if any(a.shape != (n,) for a in arrays):
        raise ValueError(f"native batch prep: every augmentation draw must have shape ({n},)")
    return arrays


def _call(name: str, images, indices, target_hw, middle: list, out, num_threads) -> None:
    n, (H, W, C), (th, tw) = len(indices), images.shape[1:], target_hw
    rc = getattr(library(), name)(_ptr(images, _u8), _ptr(indices, _i64), n, H, W, C, th, tw,
                                  *middle, out.ctypes.data_as(_f32 if out.dtype == np.float32
                                                              else _u8),
                                  num_threads or default_threads())
    if rc != 0:
        raise RuntimeError(f"native batch prep: {name} returned {rc} (1: bad sizes n={n}, "
                           f"{(H, W, C)} -> {(th, tw)}; 2: a worker thread did not start)")


def _run(name, images, indices, target_hw, mean255=None, std255=None, params=None,
         num_threads: int = 0, out=None) -> np.ndarray:
    indices = _check_pool(images, indices)
    th, tw = (int(s) for s in target_hw)
    normalize = mean255 is not None
    out = _out(out, (len(indices), th, tw, images.shape[3]),
               np.float32 if normalize else np.uint8)
    if not len(indices):
        return out
    middle = []  # pointers into stats and aug, which stay alive until the call returns
    if normalize:
        stats = [np.ascontiguousarray(s, np.float32).reshape(-1) for s in (mean255, std255)]
        if any(s.shape != (images.shape[3],) for s in stats):
            raise ValueError(f"native batch prep: mean and std need {images.shape[3]} channels")
        middle += [_ptr(s, _f32) for s in stats]
    if params is not None:
        aug = _aug_args(params, len(indices))
        middle += [_ptr(a, _i64) for a in aug[:4]] + [_ptr(aug[4], _u8)]
    _call(name, images, indices, (th, tw), middle, out, num_threads)
    return out


def prep_batch(images: np.ndarray, indices, target_hw, mean255, std255,
               num_threads: int = 0, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather + nearest resize + normalize: float32 (n, th, tw, C).  ``mean255`` /
    ``std255``: per-channel statistics on the 0..255 scale."""
    return _run("cat_prep_batch", images, indices, target_hw, mean255, std255,
                num_threads=num_threads, out=out)


def prep_batch_aug(images: np.ndarray, indices, target_hw, mean255, std255, params,
                   num_threads: int = 0, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather + crop/flip by ``params`` (``draw_aug_params``' ``(y0, x0, ch, cw,
    flip)``) + nearest resize + normalize: float32 (n, th, tw, C), ``apply_aug``
    followed by the normalization."""
    return _run("cat_prep_batch_aug", images, indices, target_hw, mean255, std255, params,
                num_threads, out)


def gather_batch(images: np.ndarray, indices, target_hw, num_threads: int = 0,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather + nearest resize: uint8 (n, th, tw, C), ``images[indices]`` resized."""
    return _run("cat_gather_batch", images, indices, target_hw, num_threads=num_threads,
                out=out)


def gather_batch_aug(images: np.ndarray, indices, target_hw, params, num_threads: int = 0,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather + crop/flip by ``params`` + nearest resize: uint8 (n, th, tw, C),
    ``apply_aug(images[indices], params, target_hw)``."""
    return _run("cat_gather_batch_aug", images, indices, target_hw, params=params,
                num_threads=num_threads, out=out)
