"""The (data, seq) device mesh (counterpart of slamtpu/parallel/mesh.py).

The scaling axes are those of the JAX package:

  * `data` - a batch of independent video sequences (pure data parallelism);
  * `seq`  - the time axis of one sequence: frames shard across devices,
    pairwise ops need a one-frame halo exchange and pose composition a
    cross-shard prefix product (parallel/sharded.py).

PyTorch's idiom for JAX's one controller over a `Mesh` is one process per
device: a `torch.distributed` process group of n ranks (NCCL between CUDA
devices, Gloo on the CPU) and a `DeviceMesh` over it. Rank r sits at
(r // seq, r % seq), the JAX mesh's row-major layout.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["DATA_AXIS", "SEQ_AXIS", "mesh_shape", "make_mesh"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def mesh_shape(n_devices: int, data: int | None = None) -> tuple[int, int]:
    """(data, seq) for n devices: with `data` unset, 2 when n is even and
    >= 4, else 1 (sequence parallelism is the more interesting axis for a
    single long video)."""
    if data is None:
        data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if n_devices % data:
        raise ValueError(f"{n_devices} devices not divisible by data={data}")
    return data, n_devices // data


def make_mesh(n_devices: int | None = None, data: int | None = None) -> DeviceMesh:
    """A (data, seq) DeviceMesh over the initialised process group, one
    rank per device (see parallel/distributed.py::initialize_multihost).

    n_devices defaults to the group's world size and must equal it. The
    mesh's device type is what the group's collectives carry: "cuda" for
    NCCL, "cpu" for Gloo; the ranks compute on their own devices either
    way."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a group of {world} ranks: one rank per device")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape(n, data), mesh_dim_names=(DATA_AXIS, SEQ_AXIS))
