"""The collectives of the sharded tree, with their bytes counted.

Everything the JAX package does across devices with ``jax.lax.all_gather``
(stacked ``[D, ...]`` or tiled along an axis) and ``jax.lax.psum`` goes
through ``all_gather`` and ``psum`` here, as calls on a rank's process
group, SPMD: every rank of the group makes the same calls in the same
order.  ``send_recv`` moves a sparse tree's slices to their new owners
when its prefix doubles (the re-shard of ``imt_tpu``'s ``_place``).

* **Bytes are counted.**  Each call appends ``(what, bytes)`` to the list
  of the program that is running (``program``): what the call carries
  (``what``, by default the op's name) and the bytes of its result on one
  rank, the D gathered pieces of an all-gather, the summed tensor of a
  psum.  ``collective_audit.py`` reads the lists.
* **Transport is explicit** (``transport``).  On an NCCL group the tensors
  go as they are.  On a gloo group, which has no CUDA collectives, a tensor
  on the card is copied to the host, reduced or gathered there and copied
  back: the state and the compute stay on the rank's device.
* Bool tensors go over as uint8 (gloo rejects uint32 and has no bool
  reduction); the trees' limbs and nodes are int32 already.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

import torch
import torch.distributed as dist

# program -> [(op, bytes)], one entry per call
CALLS: dict[str, list] = defaultdict(list)
_programs = ["other"]


def reset_counts() -> None:
    CALLS.clear()


@contextmanager
def program(name: str):
    """Count the collectives made inside the block under `name`."""
    _programs.append(name)
    try:
        yield
    finally:
        _programs.pop()


def _count(what: str, nbytes: int) -> None:
    CALLS[_programs[-1]].append((what, nbytes))


def transport(group) -> str:
    """'device' when the group's backend moves CUDA tensors itself (NCCL),
    else 'host' for tensors on the card (gloo)."""
    return "device" if dist.get_backend(group) == "nccl" else "host"


def _to_wire(x: torch.Tensor, group):
    """(tensor as it goes over the group, the dtype and device to restore)."""
    dtype, device = x.dtype, x.device
    if dtype == torch.bool:
        x = x.to(torch.uint8)
    if device.type == "cuda" and transport(group) == "host":
        x = x.cpu()
    return x.contiguous(), (dtype, device)


def _from_wire(x: torch.Tensor, like) -> torch.Tensor:
    dtype, device = like
    x = x.to(device)
    return x.to(torch.bool) if dtype == torch.bool else x


def all_gather(x: torch.Tensor, group, dim: int | None = None,
               what: str = "all_gather") -> torch.Tensor:
    """The tensors `x` of the D ranks of `group`, in rank order: stacked
    into [D, ...] (``all_gather(x, axis)``), or with `dim` concatenated
    along that dimension (``tiled=True``)."""
    wire, like = _to_wire(x, group)
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts) if dim is None else torch.cat(parts, dim=dim)
    _count(what, out.numel() * x.element_size())
    return _from_wire(out, like)


def send_recv(sends: list, recvs: list, group,
              what: str = "send_recv") -> list:
    """Point to point on `group`: each int32 tensor of `sends`, given as
    (tensor, group rank), goes to that rank; each of `recvs`, given as
    (shape, group rank, device), comes from that rank and is returned on
    that device, in the order of `recvs`.  The bytes received are counted,
    one entry per tensor."""
    ops, bufs, outs = [], [], []
    for x, dst in sends:
        wire, _ = _to_wire(x, group)
        bufs.append(wire)
        ops.append(dist.P2POp(dist.isend, wire,
                              dist.get_global_rank(group, dst), group))
    for shape, src, device in recvs:
        dev = torch.device(device)
        buf = torch.empty(shape, dtype=torch.int32,
                          device="cpu" if dev.type == "cuda" and transport(
                              group) == "host" else dev)
        outs.append((buf, dev))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    for work in (dist.batch_isend_irecv(ops) if ops else []):
        work.wait()
    for buf, _ in outs:
        _count(what, buf.numel() * buf.element_size())
    return [buf.to(dev) for buf, dev in outs]


def psum(x: torch.Tensor, group, what: str = "psum") -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (``jax.lax.psum``); exact
    in int32 where at most one rank adds a nonzero value, as every use in
    the sharded tree does."""
    wire, like = _to_wire(x, group)
    wire = wire.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    _count(what, wire.numel() * x.element_size())
    return _from_wire(wire, like)
