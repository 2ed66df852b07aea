"""Ray-batch data parallelism over ranks (counterpart of
tensorf_tpu/parallel/mesh.py).

The JAX package shards the ray batch over a 1-D device mesh, replicates
the parameters and lets GSPMD place the gradient ``psum``.  The port runs
one process per rank, each with the whole field on its device, and makes
the collectives explicit: the parameters are broadcast from rank 0 after
every event that rebuilds them (``broadcast_params``), every step sums the
ranks' gradients in one all-reduce of a flat buffer (``allreduce_grads``),
and served rows are gathered to every rank (``gather_rows``).  Each rank's
loss is assembled so that the ranks' losses sum to the global loss
(train/step.py), so the summed gradient is the one-rank gradient up to the
order of the float sums.

Two launches give ranks (parallel/launch.py): ``n_devices N`` spawns N
ranks that draw the same global batch, each rendering its contiguous block
of every sub-batch (``shard_rows``); ``distributed 1`` joins ranks started
outside the program, each drawing its own batch from its id pool
(``host_ray_pool``), as a JAX process does.  The process group is NCCL when
every rank has a card of its own and gloo on the CPU or when ranks share a
card; its collectives time out (``COLLECTIVE_TIMEOUT_S``), so a rank that
dies fails the others instead of hanging them.
"""

from __future__ import annotations

import datetime
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

# seconds a collective waits for the other ranks before it fails: longer
# than any one rank's work between two collectives (a checkpoint write on
# rank 0, a first kernel build, a whole evaluation)
COLLECTIVE_TIMEOUT_S = 1800.0


class RankGroup(NamedTuple):
    """This process's place in the default process group.  Functions that
    take ``group=None`` run as one rank without collectives; a group of one
    rank (a distributed run of world size 1) still runs them."""

    rank: int
    world: int
    backend: str  # "nccl" or "gloo"
    device: torch.device  # the rank's device; NCCL's collectives run there
    # True for distributed runs: each rank draws its own share of the batch
    # from its id pool; False for spawned runs: every rank draws the global
    # batch and renders its block of it
    pooled: bool = False


def choose_backend(devices: Sequence) -> str:
    """NCCL when every rank has a CUDA card of its own; gloo otherwise (the
    CPU, or ranks sharing a card, which NCCL refuses)."""
    devs = [torch.device(d) for d in devices]
    if not all(d.type == "cuda" for d in devs):
        return "gloo"
    ids = [0 if d.index is None else d.index for d in devs]
    return "nccl" if len(set(ids)) == len(ids) else "gloo"


def init_group(rank: int, world: int, device, init_method: str, backend: str,
               pooled: bool = False, timeout_s: float = COLLECTIVE_TIMEOUT_S) -> RankGroup:
    """Join the default process group as ``rank`` of ``world`` at
    ``init_method`` (``file://`` or ``tcp://`` or ``env://``)."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return RankGroup(rank, world, backend, device, pooled)


def destroy_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def is_writer(group: Optional[RankGroup]) -> bool:
    """Whether this rank writes the run's files: rank 0 only."""
    return group is None or group.rank == 0


def barrier(group: Optional[RankGroup]) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier()


def pad_to_multiple(arr: np.ndarray, multiple: int):
    """Pad the leading dim so batches divide evenly across devices;
    returns (padded, original_length)."""
    n = arr.shape[0]
    rem = n % multiple
    if rem == 0:
        return arr, n
    pad = multiple - rem
    return (
        np.concatenate([arr, np.broadcast_to(arr[-1:], (pad,) + arr.shape[1:])]),
        n,
    )


def host_ray_pool(n_rays: int, global_batch: int, rank: int, world: int):
    """Rank ``rank``'s id pool over the (filtered) training ray store and
    its per-step draw: (ids ``rank::world``, ``global_batch // world``), or
    (None, ``global_batch``) on one rank.  The store stays whole on every
    rank; the pools are disjoint and cover it, so the global batch is the
    disjoint union of the ranks' draws."""
    if world <= 1:
        return None, global_batch
    if global_batch % world:
        raise ValueError(
            f"batch_size {global_batch} must divide by process count {world}"
        )
    return np.arange(n_rays, dtype=np.int64)[rank::world], global_batch // world


def shard_rows(x, rank: int, world: int):
    """Rank ``rank``'s contiguous block of the leading dimension (which
    must divide by ``world``): counterpart of shard_rays' placement."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"{n} rows do not divide over {world} ranks")
    per = n // world
    return x[rank * per:(rank + 1) * per]


def _comm(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """``t`` where the backend's collectives take it: NCCL on the rank's
    card, gloo on either device."""
    return t.to(group.device) if group.backend == "nccl" else t


def broadcast_tensors(tensors: Iterable[torch.Tensor], group: Optional[RankGroup]) -> None:
    """Overwrite each tensor in place with rank 0's (one broadcast of a
    flat buffer per dtype)."""
    if group is None:
        return
    import torch.distributed as dist

    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        # gloo has no bool collectives: a bool tensor travels as its bytes
        flat = torch.cat([(t.detach().view(torch.uint8) if dtype == torch.bool else t.detach())
                          .reshape(-1) for t in ts])
        flat = _comm(flat, group)
        dist.broadcast(flat, src=0)
        offset = 0
        for t in ts:
            n = t.numel()
            part = flat[offset:offset + n].view(t.shape)
            with torch.no_grad():
                t.copy_(part.view(torch.bool) if dtype == torch.bool else part)
            offset += n


def broadcast_params(module: torch.nn.Module, group: Optional[RankGroup]) -> None:
    """Rank 0's parameters and buffers on every rank (counterpart of
    ``replicate``)."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()), group)


def allreduce_grads(params: Sequence[torch.nn.Parameter], group: Optional[RankGroup],
                    extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum every parameter's gradient over the ranks in ONE all-reduce of a
    flat float32 buffer; ``extra`` (a 1-D float32 tensor, e.g. the step's
    metrics) rides in the same buffer and its sum is returned.  A missing
    gradient is filled with zeros first, so every rank flattens the same
    sizes (Adam then steps that parameter on every rank, as optax steps
    every leaf)."""
    if group is None:
        return extra
    import torch.distributed as dist

    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.to(device=grads[0].device if grads else extra.device))
    flat = _comm(torch.cat(parts), group)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    # a copy: a view would keep the whole gradient buffer alive as long as
    # the caller keeps a metric (the loop keeps every step's loss)
    return None if extra is None else flat[offset:].to(extra.device, copy=True)


def gather_rows(x: torch.Tensor, group: Optional[RankGroup]) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated in rank
    order, on every rank (counterpart of ``to_host``).  Gloo gathers CUDA
    tensors too (checked on an H100 with two ranks sharing it: its
    all_reduce, broadcast and all_gather all take them), so no op is staged
    through the host."""
    if group is None:
        return x
    import torch.distributed as dist

    src = _comm(x.detach().contiguous(), group)
    out = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(out, src)
    return torch.cat(out).to(x.device)


def _host_reduce(vec, group: Optional[RankGroup], op: str) -> np.ndarray:
    arr = np.asarray(vec)
    if group is None:
        return arr
    import torch.distributed as dist

    t = _comm(torch.as_tensor(np.ascontiguousarray(arr, np.float64)), group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    return t.cpu().numpy().astype(arr.dtype)


def host_allsum(vec, group: Optional[RankGroup]) -> np.ndarray:
    """Element-wise sum of a fixed-shape host array over the ranks
    (identity on one rank)."""
    return _host_reduce(vec, group, "sum")


def host_allmax(vec, group: Optional[RankGroup]) -> np.ndarray:
    """Element-wise max of a fixed-shape host array over the ranks
    (identity on one rank)."""
    return _host_reduce(vec, group, "max")


def param_digest(module: torch.nn.Module) -> float:
    """A float64 digest of every parameter (their sum and a position-weighted
    sum), to compare the ranks' copies: bit-identical parameters give the
    same digest."""
    total = 0.0
    with torch.no_grad():
        for p in module.parameters():
            x = p.detach().reshape(-1).to(torch.float64)
            w = torch.arange(1, x.numel() + 1, device=x.device, dtype=torch.float64)
            total += float(x.sum()) + float((x * w).sum()) * 1e-7
    return total
