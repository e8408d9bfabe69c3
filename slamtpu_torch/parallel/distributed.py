"""Multi-process plumbing (counterpart of slamtpu/parallel/distributed.py).

One process per device, joined in a `torch.distributed` process group:

  * `initialize_multihost` - process-group set-up, from explicit arguments,
    the SLAMTPU_COORDINATOR / SLAMTPU_NUM_PROCESSES / SLAMTPU_PROCESS_ID
    variables, torchrun's `env://`, or else a one-process group on a free
    local port (a one-GPU user gets a (1, 1) mesh in two calls);
  * `global_mesh` - the (data, seq) mesh over every rank;
  * `from_process_local` - this rank's [B_local, T_local, ...] block of a
    global array under the (data, seq) sharding, or a check of a block the
    rank was handed: in SPMD PyTorch a rank holds only its own block;
  * `local_time_slice` - the [t0, t1) of the time axis this rank covers.

Every collective of the package goes through the helpers at the end of this
file. Each puts its tensor on the group's device (the rank's CUDA device
for NCCL, the CPU for Gloo, which carries no CUDA tensor) and the result
back on the caller's; the compute stays on the rank's device. A failed
collective raises; nothing switches backend or device on its own.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from .. import resolve_device
from .mesh import DATA_AXIS, SEQ_AXIS, make_mesh

__all__ = ["initialize_multihost", "global_mesh", "from_process_local", "local_time_slice"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, device=None, backend: str | None = None):
    """Join (or create) the process group; returns (rank, world_size).

    coordinator_address "host:port" with num_processes and process_id, or
    the SLAMTPU_* variables for any of them left None; without a
    coordinator, torchrun's variables (`env://`); without those, a
    one-process group on a free local port. device: what this rank computes
    on, "cuda" unless the caller asks for the CPU (raises without a card).
    backend: NCCL for a CUDA device and Gloo for the CPU unless named
    ("gloo" on CUDA ranks carries the collectives through the host). On
    CUDA the rank's device becomes the current one: LOCAL_RANK when set,
    else the rank modulo the visible devices.
    """
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA ranks; use Gloo on the CPU")
    env = os.environ
    coordinator_address = coordinator_address or env.get("SLAMTPU_COORDINATOR")
    if num_processes is None and env.get("SLAMTPU_NUM_PROCESSES"):
        num_processes = int(env["SLAMTPU_NUM_PROCESSES"])
    if process_id is None and env.get("SLAMTPU_PROCESS_ID"):
        process_id = int(env["SLAMTPU_PROCESS_ID"])
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        init_method, world, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(data: int | None = None):
    """The (data, seq) mesh over every rank of the group, in rank order."""
    return make_mesh(data=data)


def axis(mesh, name: str) -> tuple[int, int]:
    """(this rank's coordinate, size) along the mesh axis `name`."""
    return mesh.get_local_rank(name), mesh.shape[mesh.mesh_dim_names.index(name)]


def from_process_local(mesh, array, global_shape=None):
    """This rank's [B / data, T / seq, ...] block of an array sharded like
    the frames of sharded_vo_step (batch over `data`, time over `seq`).

    Given the global array (global_shape None or its own shape), the block
    is cut out of it; given a block and the global shape, the block's
    shape is checked and the block returned. Raises when neither fits."""
    full = tuple(array.shape) if global_shape is None else tuple(global_shape)
    d, n_data = axis(mesh, DATA_AXIS)
    s, n_seq = axis(mesh, SEQ_AXIS)
    b, t = full[:2]
    if b % n_data or t % n_seq:
        raise ValueError(f"{b} sequences of {t} frames do not shard evenly over a ({n_data}, {n_seq}) mesh")
    b_loc, t_loc = b // n_data, t // n_seq
    if tuple(array.shape) == full:
        return array[d * b_loc:(d + 1) * b_loc, s * t_loc:(s + 1) * t_loc]
    if tuple(array.shape) == (b_loc, t_loc, *full[2:]):
        return array
    raise ValueError(f"a block of shape {tuple(array.shape)} is neither {full} nor this rank's "
                     f"{(b_loc, t_loc, *full[2:])}")


def local_time_slice(mesh, t_total: int) -> tuple[int, int]:
    """[t0, t1) of the global time axis this rank covers under the seq
    sharding."""
    s, n_seq = axis(mesh, SEQ_AXIS)
    if t_total % n_seq:
        raise ValueError(f"{t_total} frames not divisible by seq={n_seq}")
    per_shard = t_total // n_seq
    return s * per_shard, (s + 1) * per_shard


# ---------------------------------------------------------------------------
# Collectives. Each moves its tensor to the group's device and the result
# back to the caller's device.
# ---------------------------------------------------------------------------


def group_device(group) -> torch.device:
    """The device a group's collectives carry: the current CUDA device for
    NCCL, the CPU for Gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def pack(tensors) -> torch.Tensor:
    """The bytes of `tensors` as one flat uint8 tensor (one message instead
    of one per tensor; bool and uint8 travel on every backend this way)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def unpack(buf: torch.Tensor, like) -> list:
    """Inverse of `pack`: tensors shaped and typed like `like`, from `buf`."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].clone().view(t.dtype).reshape(t.shape))  # a copy starts aligned
        at += n
    return out


def all_gather(group, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's `tensor` stacked in group-rank order: [n, *shape], on
    the tensor's device."""
    dev = group_device(group)
    src = tensor.contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(tensor.device)


def gather_to_first(group, tensor: torch.Tensor):
    """Every rank's `tensor` stacked in group-rank order on group rank 0
    ([n, *shape], on the tensor's device); None on the other ranks."""
    dev = group_device(group)
    src = tensor.contiguous().to(dev)
    first = dist.get_rank(group) == 0
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))] if first else None
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    return torch.stack(parts).to(tensor.device) if first else None


def shift_right(group, tensor: torch.Tensor):
    """Send `tensor` to the next rank of the group and receive the previous
    rank's (all ranks' tensors have one shape): one batch of point-to-point
    ops. Returns the received tensor on `tensor`'s device, None on group
    rank 0 (the last rank sends nothing)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    dev = group_device(group)
    ops, received = [], None
    if rank + 1 < n:
        ops.append(dist.P2POp(dist.isend, tensor.contiguous().to(dev), dist.get_global_rank(group, rank + 1), group))
    if rank > 0:
        received = torch.empty(tensor.shape, dtype=tensor.dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, received, dist.get_global_rank(group, rank - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if received is None else received.to(tensor.device)


def broadcast_object(obj, src: int = 0):
    """`obj` of global rank `src`, on every rank of the default group."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's picklable `obj`, in global rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
