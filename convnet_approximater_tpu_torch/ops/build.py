"""Build CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  :func:`launch_range` names a
launch for ``torch.profiler``.  Each kernel is a ``torch.library`` custom op
under ``NAMESPACE`` (its module in ``ops/`` registers it), so that
``torch.export`` traces through it: the op's CPU implementation is the plain
version, its CUDA implementation the launch, its fake kernel the output's
shape.  The library lands in ``build/torch_kernels/`` at the repository root,
named by a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one is reused.  :func:`build_all` starts one nvcc per source, all
at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

NAMESPACE = "convnet_approximater_tpu_torch"  # the custom ops' torch.ops.<NAMESPACE>.<op>
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, then ``$PATH``, then the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(source: str) -> Path:
    """The library of ``csrc/<source>``, named by a hash of the source, the
    ``csrc/`` headers it may include, and the flags."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[str]) -> Dict[str, float]:
    """Compile the ``csrc/`` sources that are not built yet, one nvcc process
    each, all started together; return each source's build seconds (0.0 for a
    library that was built already).

    The compiler's output, ptxas register and spill counts included, is kept
    beside each library as ``<name>.log``.
    """
    seconds = {source: 0.0 for source in sources}
    todo = [source for source in sources if not library_path(source).exists()]
    if not todo:
        return seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for source in todo:
        lib = library_path(source)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        jobs[source] = (lib, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    failed = []
    while jobs:
        for source, (lib, tmp, log, proc) in list(jobs.items()):
            if proc.poll() is None:
                continue
            seconds[source] = time.perf_counter() - t0
            log.close()
            del jobs[source]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source} ({proc.returncode}):\n"
                              f"{lib.with_suffix('.log').read_text()[-4000:]}")
            else:
                os.replace(tmp, lib)
        time.sleep(0.02)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it."""
    build_all([source])
    return ctypes.CDLL(str(library_path(source)))


def check_device(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` lies on the CPU (the op's plain version) or a CUDA
    card (its kernel); the meta device would reach the fake kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def launch_range(name: str):
    """A ``record_function`` range named after a kernel's wrapper while
    ``torch.profiler`` records, so that the kernels a launch puts on the card
    are attributed to it (``utils/trace.py``); no range otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
