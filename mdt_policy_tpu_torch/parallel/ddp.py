"""Data parallel over processes, one a device (the port's counterpart of
`mdt_policy_tpu/parallel/mesh.py` and of the JAX loop's
`_init_distributed`).

JAX shards a 1-D `data` mesh inside one program: parameters replicated,
batches split on their leading axis, and XLA inserts the gradient psum and
the contrastive loss's all-gather. The port runs one process per GPU, the
PyTorch idiom and what the reference ran (DDP over NCCL), with the
collectives written out:

* `init_distributed` joins the process group: NCCL on CUDA (the device
  `cuda:{LOCAL_RANK}`), gloo on the CPU;
* `broadcast_trainables` copies rank 0's trainables and EMA to every rank
  (the port's `replicate_tree`: the same weights everywhere, enforced);
* `all_reduce_gradients` averages the gradients over the ranks, one
  flattened bucket a dtype in the caller's parameter order;
* `all_gather_with_grad` gathers a batch-leading tensor in rank order and
  sends its gradient back (the reference's `all_gather(sync_grads=True)`);
* `reduce_metrics` averages host metrics over the ranks.

There is no `DistributedDataParallel` wrapper: the train step runs two
forwards (the `vis` and `lang` scopes) before its one backward and fills
the gradients of unused parameters with zeros itself, neither of which
DDP's reducer allows. With no process group every function is the
one-process identity.
"""

from __future__ import annotations

import datetime
import inspect
import os
import socket
from typing import Dict, Iterable, List, Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["all_gather_objects", "all_gather_with_grad", "all_reduce_gradients", "barrier",
           "broadcast_trainables", "check_equal_rows", "free_port", "init_distributed",
           "is_initialized", "is_lead", "rank", "reduce_metrics", "shutdown", "vote",
           "world_size"]

# how long a collective, the rendezvous included, may wait for the other
# ranks before it raises (a rank running a long rollout shard is waited for)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
# the DistributedConfig field that stands in for each torchrun variable
_FIELDS = {"WORLD_SIZE": "num_processes", "RANK": "process_id"}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The group's number of processes; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def is_lead() -> bool:
    """Rank 0, the one that writes the run directory."""
    return rank() == 0


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(cfg, device=None, *,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group of a data-parallel run and return this rank's
    device (the JAX loop's `_init_distributed`, training.py:351-367).

    `cfg` is the run's `DistributedConfig`: `coordinator_address`
    ("host:port", rendezvous at tcp://host:port), `num_processes` (the world
    size) and `process_id` (the rank). A field left None is read from
    torchrun's environment (`MASTER_ADDR`/`MASTER_PORT`, `WORLD_SIZE`,
    `RANK`). The local rank is `LOCAL_RANK`, else the rank (one node).
    On CUDA (`device` None or a CUDA device) the backend is NCCL and the
    device `cuda:{local rank}`, made current; on the CPU it is gloo.
    `timeout` bounds the rendezvous and every collective."""
    env = os.environ

    def field(value, name):
        if value is not None:
            return int(value)
        if name not in env:
            raise ValueError(f"distributed: set distributed.{_FIELDS[name]} or run under "
                             f"torchrun (no {name} in the environment)")
        return int(env[name])

    world = field(cfg.num_processes, "WORLD_SIZE")
    this = field(cfg.process_id, "RANK")
    if cfg.coordinator_address:
        init_method = f"tcp://{cfg.coordinator_address}"
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    else:
        raise ValueError("distributed: set distributed.coordinator_address (host:port) "
                         "or run under torchrun (no MASTER_ADDR/MASTER_PORT)")
    local = int(env.get("LOCAL_RANK", this))
    device = torch.device("cuda" if device is None else device)
    kwargs = {}
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} needs a CUDA device {local}; "
                               f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kwargs["device_id"] = device  # bind the group to it (torch >= 2.3)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=this,
                            timeout=timeout, **kwargs)
    return device


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if is_initialized():
        dist.destroy_process_group()
    _EQUAL_ROWS.clear()


# the row counts every rank of the current group was seen to share
_EQUAL_ROWS: set = set()


def check_equal_rows(rows: int) -> None:
    """Raise unless every rank passes the same `rows`. The first time this
    rank passes a number it takes one all-reduce (a host sync); a number
    already agreed on costs nothing."""
    if not is_initialized() or rows in _EQUAL_ROWS:
        return
    t = torch.tensor([rows, -rows], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    most, least = t[0].item(), -t[1].item()
    if most != least:
        raise ValueError(f"data parallel needs equal per-rank batches; the ranks hold "
                         f"{least} to {most} rows")
    _EQUAL_ROWS.add(rows)


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _buckets(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    """The tensors grouped by dtype, each group in the order given."""
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat_collective(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run `collective(flat)` on one flattened copy of each dtype's tensors
    and copy the result back into them, in place (one multi-tensor copy:
    a copy a tensor costs the host more than the collective)."""
    for group in _buckets(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        pieces = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [piece.view(t.shape) for piece, t in zip(pieces, group)])


@torch.no_grad()
def broadcast_trainables(net, ema: Mapping[str, torch.Tensor]) -> None:
    """Rank 0's trainable parameters and EMA on every rank, in place."""
    if not is_initialized():
        return
    names = [n for n, _ in net.trainable_parameters()]
    tensors = [p.data for _, p in net.trainable_parameters()] + [ema[n] for n in names]
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=0))


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every parameter's `.grad` replaced by its mean over the ranks: one
    flattened bucket a dtype, in the order of `params` (the same on every
    rank), summed, then divided by the world size. Over one rank it changes
    no bit."""
    if not is_initialized():
        return
    world = world_size()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(world)
    _flat_collective([p.grad for p in params], mean)


class _AllGather(torch.autograd.Function):
    """Forward: the ranks' tensors concatenated in rank order on dim 0.
    Backward: the gradient summed over the ranks, this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = rank() * ctx.rows
        return grad[start:start + ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """`x` (b, ...) of every rank as one (world * b, ...) tensor in rank
    order, differentiable: the gradient of the gathered tensor is summed over
    the ranks and each rank gets its own rows (every rank computes the same
    loss of the gathered tensor, and the gradients are averaged afterwards).
    Every rank must pass the same shape. Without a group: `x`."""
    if not is_initialized():
        return x
    return _AllGather.apply(x)


def _collective_device() -> torch.device:
    """Where the group's tensors live: this rank's CUDA device under NCCL,
    else the CPU."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_metrics(metrics: Mapping[str, object]) -> Dict[str, float]:
    """The metrics (numbers or one-element tensors) averaged over the ranks,
    as floats; one all-reduce. Call it at log points only: it syncs."""
    if not is_initialized() or world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    dev = _collective_device()
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float64).to(dev).reshape(())
                        for k in keys])
    dist.all_reduce(vals)
    vals = (vals / world_size()).tolist()
    return dict(zip(keys, vals))


def vote(flag: bool) -> torch.Tensor:
    """The number of ranks that pass a true `flag`, as a one-element tensor
    whose all-reduce is queued, not waited for: read it a step later and it
    costs no stall. Every rank must call it at the same point."""
    t = torch.full((1,), float(flag), device=_collective_device())
    if is_initialized():
        dist.all_reduce(t)
    return t


def all_gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order; `[obj]` without a group."""
    if not is_initialized():
        return [obj]
    out: List[Optional[object]] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
