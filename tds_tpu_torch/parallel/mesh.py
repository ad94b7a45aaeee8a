"""Batch splitting over ranks (counterpart of tds_tpu/parallel/mesh.py).

The physics batch is the only scaling axis: in the JAX package env batches
shard over a 1-D ``data`` mesh of devices and GSPMD inserts the
collectives. Here a mesh is the process group, this rank, the world size
and the rank's device; :func:`shard_batch` takes the rank's contiguous
slice of the leading axis and :func:`gather_batch` is the gather GSPMD
inserts implicitly: every rank's slice, concatenated back in rank order.

Usage:
    mesh = make_mesh()                    # after initialize_distributed()
    step = make_train_step(env, policy, config, mesh=mesh)   # learn.ars
    local = shard_batch(qs, mesh)         # this rank's rows
"""

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map


class Mesh(NamedTuple):
    group: Optional[object]  # the process group; None: the default group, or no group at world size 1
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"


class BatchSharding(NamedTuple):
    """Rows [rank * n / size, (rank + 1) * n / size) of a batch of n."""

    rank: int
    size: int

    def bounds(self, n: int):
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def make_mesh(device=None, axis_name: str = "data", group=None) -> Mesh:
    """The mesh of ``group`` (None: the default process group) with this
    rank's device (None: the one ``initialize_distributed`` gave it). With
    no process group a mesh of one rank on ``device``."""
    from tds_tpu_torch.parallel import distributed
    from tds_tpu_torch.utils.tensors import resolve_device

    device = torch.device(device) if device is not None else distributed._device or resolve_device(None)
    if not dist.is_initialized():
        return Mesh(None, 0, 1, device, axis_name)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device, axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> BatchSharding:
    """The split of a leading (batch) axis over the mesh's ranks."""
    return BatchSharding(mesh.rank, mesh.size)


def replicated(mesh: Mesh) -> BatchSharding:
    """Every rank holds every row."""
    return BatchSharding(0, 1)


def shard_batch(tree, mesh: Mesh, axis_name: str = "data"):
    """This rank's rows of every leaf's leading axis, on the mesh's device."""
    sh = batch_sharding(mesh, axis_name)

    def take(x):
        lo, hi = sh.bounds(x.shape[0])
        return x[lo:hi].to(mesh.device)

    return tree_map(take, tree)


def gather_batch(tree, mesh: Mesh):
    """Every rank's leading-axis rows of each leaf, concatenated in rank
    order on every rank. Each rank writes its rows into a zeroed buffer of
    the full size and the buffers are summed (``all_reduce``): adding zeros
    is exact, and NCCL and gloo both reduce CUDA tensors, where gloo's
    ``all_gather`` may not. Call it on every rank with the same shapes.
    Without a process group (a one-rank mesh) the tree itself."""
    if not dist.is_initialized():
        if mesh.size != 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks needs initialize_distributed()")
        return tree

    def gather(x):
        local = x.shape[0]
        as_int = x.dtype == torch.bool
        full = x.new_zeros((local * mesh.size,) + tuple(x.shape[1:]), dtype=torch.uint8 if as_int else x.dtype)
        full[mesh.rank * local : (mesh.rank + 1) * local] = x
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
        return full.bool() if as_int else full

    return tree_map(gather, tree)


def constrain_batch(tree, mesh: Optional[Mesh], axis_name: str = "data"):
    """This rank's rows of the batch (:func:`shard_batch`); the tree itself
    when ``mesh`` is None."""
    if mesh is None:
        return tree
    return shard_batch(tree, mesh, axis_name)
