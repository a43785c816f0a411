"""The device mesh of a torch.distributed program (the port of
``snarkos_tpu/parallel/mesh.py``) and the collectives of the sharded paths.

A ``Mesh`` is one rank's view of a one-axis mesh: the process group, this
rank, the world size and the device this rank computes on. Arrays are
sharded along their trailing axis in contiguous blocks, rank r holding
[r n/D, (r + 1) n/D) (``shard_last``), as the JAX package's
``P(None, ..., "x")`` places them.

``all_gather_last`` and ``all_to_all`` have the semantics of JAX's tiled
collectives (``lax.all_gather(..., axis=-1, tiled=True)`` and
``lax.all_to_all(..., tiled=True)``). They are built on the list form of
``dist.all_gather`` and on ``dist.all_to_all_single``, which NCCL and gloo
both take, on CPU and CUDA tensors alike.

``spawn`` runs a function on ``world`` new processes, one rank each, and
returns what each rank returned: the ``spawn`` start method (never a fork
of a process that may have initialised CUDA), rendezvous through a file in
a new temporary directory (never a fixed port, so concurrent callers do not
collide), and any rank that raises fails the whole call.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from snarkos_tpu_torch.ops import _build

# how long a spawned rank waits for the others at the rendezvous and in a
# gloo collective before it fails (torch's default is 30 minutes)
RANK_TIMEOUT_S = 300


@dataclass(frozen=True)
class Mesh:
    """One rank of a one-axis device mesh."""

    group: object  # the torch.distributed process group
    rank: int
    world: int
    device: torch.device


def _local_device(device, local_rank: int) -> torch.device:
    """``None`` or ``"cuda"`` is this rank's card, ``cuda:<local_rank>``; a
    device with an index is taken as it is (ranks may share a card). A card
    that does not exist raises, as ``_build.resolve_device`` does."""
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = _build.resolve_device(dev)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {dev}: this host has "
                           f"{torch.cuda.device_count()}")
    return dev


def make_mesh(num_devices: int | None = None, backend: str | None = None,
              device=None) -> Mesh:
    """This rank's mesh, inside an initialised process group or, when there
    is none, from torchrun's environment variables (``env://``).

    ``device=None`` is ``cuda:<LOCAL_RANK>`` and raises without that card;
    pass ``"cpu"`` for a CPU rank. ``backend=None`` is the group's own
    backend, or for a new group ``nccl`` on a card and ``gloo`` on the CPU;
    gloo may be asked for on a card (ranks that share one card).
    ``num_devices``, if given, must be the world size."""
    dev = _local_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://")
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_mesh: requested {num_devices} devices; the process "
                         f"group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), world=world, device=dev)


def shard_last(mesh: Mesh, full: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the trailing axis of ``full``, on the
    mesh's device."""
    n = full.shape[-1]
    if n % mesh.world:
        raise ValueError(f"shard_last: {n} is not a multiple of {mesh.world} ranks")
    w = n // mesh.world
    return full[..., mesh.rank * w:(mesh.rank + 1) * w].to(mesh.device).contiguous()


def replicate(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``jax.device_put(arr, NamedSharding(mesh, P()))``: every rank ends with
    rank 0's ``t`` on its device (``dist.broadcast`` from rank 0; the other
    ranks' ``t`` gives only the shape and dtype). Returns a new tensor."""
    out = t.to(mesh.device, copy=True).contiguous()
    dist.broadcast(out, src=0, group=mesh.group)
    return out


def all_gather_last(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather(t, axis, axis=-1, tiled=True)``: every rank's ``t``
    concatenated along the trailing axis in rank order, on every rank (the
    inverse of ``shard_last``)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=-1)


def all_to_all(mesh: Mesh, t: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
    ``t`` is cut into world-size chunks along ``split_axis``, chunk i goes to
    rank i, and the chunks received are concatenated along ``concat_axis``
    in source-rank order. Returns a contiguous tensor."""
    d = mesh.world
    nd = t.dim()
    split_axis %= nd
    concat_axis %= nd
    if t.shape[split_axis] % d:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(t.shape)} is not a "
                         f"multiple of {d} ranks")
    # (d, ...): chunk i of the split axis leads, as all_to_all_single sends it
    send = t.unflatten(split_axis, (d, t.shape[split_axis] // d)).movedim(split_axis, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    # recv[i] came from rank i: put the source axis just before the concat
    # axis and merge the two
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1).contiguous()


def _rank_main(rank: int, fn, world: int, backend: str, device, tmp: str, args) -> None:
    dev = _local_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    out = fn(make_mesh(world, backend, dev), *args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device, *args) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` new processes and return each
    rank's result, in rank order. ``fn`` is a module-level function (it is
    sent by name); its arguments and result go through pickling and
    ``torch.load``: tensors, numbers, strings and containers of them.
    ``device`` is each rank's device: ``"cpu"``, ``None`` or ``"cuda"`` for
    card r on rank r, or a card named by index for every rank."""
    tmp = tempfile.mkdtemp(prefix="mesh-")
    try:
        torch.multiprocessing.spawn(_rank_main, args=(fn, world, backend, device, tmp, args),
                                    nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
