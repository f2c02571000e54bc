"""Process identity and process-group set-up (port of
``convnet_approximater_tpu/parallel/distributed.py``).

The JAX package runs one process per host, which sees every local device.
The port runs one process per device, as the reference did under
``torchrun`` (``dist_main.sh``): a rank owns one card, ``cuda:LOCAL_RANK``,
and ranks talk through ``torch.distributed``, over NCCL on CUDA and over gloo
on the CPU.  The rank itself is read in one place,
``utils/logger.py::get_rank``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from convnet_approximater_tpu_torch.utils.logger import get_rank

# what spatial sharding (parallel/spatial.py) does not carry: training and autograd under it, a
# pipeline beside it, compile_serving of a spatial model.  The JAX package lays out eval forwards
# alone this way (__graft_entry__.py's dryrun_multichip, tests/test_parallel.py)
MESH_TODO = ("spatial sharding serves eval forwards of every model family; training or autograd "
             "under it, a pipeline beside it and compile_serving of a spatial model are not owed "
             "by the JAX package (ROADMAP.md queue 1 item 12b, closed)")


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           device="cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) the
    group comes from the environment; otherwise from ``coordinator_address``
    (``host:port`` for a TCP store, or any ``init_method`` URL such as
    ``file:///path``) with ``num_processes`` ranks, this one ``process_id``.
    Without either it is a no-op: one process.  The backend is NCCL when
    ``device`` is CUDA, and gloo when the caller asks for the CPU; a CUDA rank
    takes ``cuda:LOCAL_RANK`` (``process_id`` modulo the visible cards without
    ``torchrun``) as its current device.  A group that already exists is kept.
    """
    device = torch.device(device)
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (from_env or coordinator_address is not None or dist.is_initialized()):
        return device
    if device.type == "cuda":
        if device.index is None:
            local = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
                     else int(process_id if process_id is not None else get_rank()))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if from_env:
            dist.init_process_group(backend, init_method="env://")
        else:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                    rank=int(process_id))
    return device


def shutdown_distributed():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    return get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device_count() -> int:
    """Cards this process can see (1 on the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
