"""Data-parallel training over R ranks, one process per GPU (counterpart of
the JAX package's `parallel/mesh.py`).

The JAX package trains on a one-axis 'data' mesh over every device it sees:
the state is replicated, the batch is sharded on axis 0, XLA inserts the
gradient reduction, and BatchNorm in train mode reduces over the global
array. Here a rank is the counterpart of a device, and a node (the ranks of
one machine, `torchrun --nproc-per-node=R`) the counterpart of a process:

 - each node cuts its own batches (`--batchsize` frames a node) from a
   sampler seeded by `process_local_seed(seed, node, nodes)`, and each of its
   ranks loads and trains on its rows of them, `local_rows(batchsize,
   local_rank, local_ranks)`;
 - every rank draws the augmentation of the whole batch of all ranks from
   the same generator and keeps its rows, so the draws are those of one
   process on the whole batch;
 - BatchNorm in training reduces its statistics over the ranks
   (`models/backbones/common.py`), the gradients are averaged over the ranks
   in one flat buffer before the clip, and the reported metrics are those of
   the whole batch (`train/loop.py`), so the parameters, buffers and Adam
   moments stay bit-equal across ranks.

Two process groups: `group`, the device's (NCCL on the card, gloo on the
CPU or when asked for), for the step's reductions; `host_group` (gloo), for
the host values that the ranks must agree on (K1's plan, pad sizes, whether
a CUDA graph is captured, the validation loss, a seed). Only `all_reduce`
(sum, max) and `broadcast` are used: gloo has exactly these two for CUDA
tensors. A process started without `WORLD_SIZE` in its environment (no
`torchrun`) is one rank with no process group, as before.
"""

import dataclasses
import os
import random
from typing import Any, List, Optional, Sequence, Tuple

import torch

from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device

_SEED_MODULUS = 2**31 - 1
_MASK_SEED_MODULUS = 2**62


def process_local_seed(seed: Optional[int], node: int, nodes: int) -> Optional[int]:
    """The sampler seed of node `node` of `nodes` (the JAX package's
    `process_local_seed` with the node as the process index): None, and the
    seed of a single node, stay as they are."""
    if seed is None or nodes == 1:
        return seed
    return int((seed * 1000003 + 7919 * node) % _SEED_MODULUS)


def local_rows(n: int, rank: int, ranks: int) -> slice:
    """The rows of a batch of `n` that rank `rank` of `ranks` takes: the
    `rank`-th of `ranks` equal blocks, as a batch sharded on axis 0 over a
    mesh of `ranks` devices places them."""
    if n % ranks:
        raise ValueError(f"a batch of {n} rows does not split evenly over {ranks} ranks")
    b = n // ranks
    return slice(rank * b, (rank + 1) * b)


def _ops():
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place among the ranks, and its process groups (none
    for a process that runs alone)."""

    rank: int = 0
    ranks: int = 1
    local_rank: int = 0
    local_ranks: int = 1
    group: Any = None  # the device's collectives
    host_group: Any = None  # gloo, for values on the host

    def __deepcopy__(self, memo):  # process groups are handles of the process; a copied model shares them
        return self

    @property
    def node(self) -> int:
        return self.rank // self.local_ranks

    @property
    def nodes(self) -> int:
        return self.ranks // self.local_ranks

    @property
    def active(self) -> bool:
        """Whether the step reduces over a process group."""
        return self.group is not None

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of `n` rows of all ranks."""
        return local_rows(n, self.rank, self.ranks)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced in place over `group` (on the device, no host sync
        with NCCL)."""
        import torch.distributed as dist

        dist.all_reduce(t, op=_ops()[op], group=self.group)
        return t

    def host_all_reduce(self, values: Sequence, op: str = "max", dtype: torch.dtype = torch.float64) -> List:
        """`values` reduced over the ranks on the host; as given with no group."""
        if self.host_group is None:
            return list(values)
        import torch.distributed as dist

        t = torch.tensor(list(values), dtype=dtype)
        dist.all_reduce(t, op=_ops()[op], group=self.host_group)
        return t.tolist()

    def host_broadcast(self, values: Sequence, dtype: torch.dtype = torch.float64) -> List:
        """Rank 0's `values` on every rank."""
        if self.host_group is None:
            return list(values)
        import torch.distributed as dist

        t = torch.tensor(list(values), dtype=dtype)
        dist.broadcast(t, 0, group=self.host_group)
        return t.tolist()

    def barrier(self):
        """Return when every rank has called it (an all-reduce on the host)."""
        self.host_all_reduce([0], "sum", torch.int32)

    def agreed_seed(self, seed: Optional[int]) -> Optional[int]:
        """`seed`; where it is None and there are several ranks, one drawn
        by rank 0 from the OS's entropy, the same on every rank."""
        if seed is not None or self.host_group is None:
            return seed
        return int(self.host_broadcast([random.SystemRandom().randrange(_SEED_MODULUS)], torch.int64)[0])

    def mask_seed(self, seed: int) -> int:
        """A forward's dropout and stochastic-depth seed, the rank folded in
        (rank 0 keeps the seed of one process): each rank draws its own masks."""
        if self.rank == 0:
            return seed
        return int((seed * 1000003 + 7919 * self.rank) % _MASK_SEED_MODULUS)

    def close(self):
        """Destroy the process groups (a no-op without them)."""
        if self.group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _cuda_of_local_rank(dev: torch.device, local_rank: int) -> torch.device:
    return torch.device("cuda", local_rank) if dev.type == "cuda" and dev.index is None else dev


def init_from_env(device: DeviceLike = None, backend: Optional[str] = None) -> Tuple[DataParallel, torch.device]:
    """This process's `DataParallel` and device from `torchrun`'s variables
    in the environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`).

    The device is `device` (default: the card), `cuda:LOCAL_RANK` where it
    names the card without an index. The backend is NCCL on the card and
    gloo on the CPU, or `backend` where given (gloo on the card: several
    ranks sharing one card). Without `WORLD_SIZE` there is one rank and no
    process group. With a group, one all-reduce runs before this returns, so
    the communicator exists before any CUDA graph captures a collective."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        return DataParallel(), resolve_device(device)
    import torch.distributed as dist

    rank, ranks = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", ranks))
    if ranks % local_ranks or not 0 <= local_rank < local_ranks:
        raise ValueError(f"rank {local_rank} of {local_ranks} on a node of a world of {ranks}")
    dev = _cuda_of_local_rank(resolve_device(device), local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", rank=rank,
                            world_size=ranks)
    host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    dp = DataParallel(rank, ranks, local_rank, local_ranks, dist.group.WORLD, host_group)
    dp.all_reduce_(torch.zeros(1, device=dev))
    return dp, dev
