"""Multi-process scaling over ``torch.distributed`` (counterpart of
tds_tpu/parallel/distributed.py).

Each process (a rank) drives one device; ARS's only cross-rank traffic is
the gather of its rollouts' rewards, step counts and observation sums, a
few KB an iteration, so the env batches stay on their ranks' devices.

Under torchrun:
    device = initialize_distributed()   # reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
    mesh = global_mesh()                # the process group, this rank and its device
    step = make_train_step(env, policy, cfg, mesh=mesh)   # learn.ars

The backend is NCCL for a CUDA device and gloo for the CPU; the caller may
name gloo for CUDA tensors (several ranks on one card, which NCCL refuses).
"""

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

_device: Optional[torch.device] = None
JOIN_TIMEOUT = datetime.timedelta(seconds=300)  # for every rank to join, and for each collective after


def _rank_device(device, rank: int) -> torch.device:
    """The named device, else ``cuda:LOCAL_RANK`` (LOCAL_RANK defaulting to
    the rank); raises when that card does not exist."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(
            f"rank {rank} (local rank {local}) has no CUDA device of its own ({count} visible): "
            "name its device (device='cuda:0' with backend='gloo' to share a card, device='cpu' for the CPU)"
        )
    return torch.device("cuda", local)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator_address`` is ``host:port`` (``tcp://`` is added) or an
    init method such as ``file:///path``; without it torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` are read.
    A configuration that fails to join raises. With no configuration at
    all the process stays single-process (a warning, as in the JAX
    package) and the device is still resolved. ``backend`` None: NCCL
    for a CUDA device, gloo else."""
    global _device
    if dist.is_initialized():
        return _device
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    _device = _rank_device(device, rank)
    if addr is None:
        logging.getLogger(__name__).warning(
            "no coordinator (MASTER_ADDR/MASTER_PORT unset, no coordinator_address): continuing single-process"
        )
        return _device
    init_method = addr if "://" in addr else f"tcp://{addr}"
    backend = backend or ("nccl" if _device.type == "cuda" else "gloo")
    if _device.type == "cuda":
        torch.cuda.set_device(_device)
    config = {"init_method": init_method, "world_size": world, "rank": rank, "backend": backend}
    try:
        dist.init_process_group(timeout=JOIN_TIMEOUT, **config)
    except Exception as e:  # the store's and backends' errors have no common base
        # a cluster was configured: going on alone would run the job on
        # 1/Nth of its devices
        raise RuntimeError(f"torch.distributed.init_process_group failed with {config}: {e}") from e
    return _device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_name: str = "data"):
    """The 1-D mesh of every rank of the process group."""
    from tds_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_name=axis_name)


def local_batch_size(global_batch: int) -> int:
    """This rank's share of a batch split over every rank."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over {n} ranks")
    return global_batch // n


def is_primary() -> bool:
    """True on the rank that logs and writes checkpoints."""
    return process_index() == 0
