"""Multi-process wiring (counterpart of linear_tpu.parallel.dist).

`init_distributed` joins this process to a torch.distributed process group
from torch's standard environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK), as `torchrun` or a spawning parent sets it. It imports
torch.distributed only when there is a group to join, and touches no CUDA
device: the CLI calls it before its worker pool forks.

The backend is the caller's choice and is never changed here: NCCL for
CUDA tensors on one card a rank, gloo for CPU tensors. Ranks that share one
card (NCCL refuses two ranks on one device) pass "gloo" themselves.
"""
from __future__ import annotations

import os


def init_distributed(backend: str) -> int:
    """Join the process group described by the environment, with
    `backend` ("nccl" or "gloo"). A no-op when WORLD_SIZE is unset or 1, or
    the group is already up. Returns this process's rank (0 when not
    distributed)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method="env://",
                                world_size=world,
                                rank=int(os.environ["RANK"]))
    return dist.get_rank()
