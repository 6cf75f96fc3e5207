"""Multi-process distribution (``snail_tpu.parallel.distributed``): the
rebuild of the reference's MPI layer on ``torch.distributed``.

The reference scales across machines with OpenMPI: rank 0 (the server)
broadcasts the scene/BVH once per connection and per-frame config every
frame, render nodes send compressed tiles back point-to-point
(reference src/comm_mpi.cpp:7-28, src/server.cpp:178-265,
src/node.cpp:210-359). Here:

  reference                          ->  here
  -------------------------------------------------------------------
  mpirun -np N node.sh                   one process per device, each
  (readme_distributed.txt:2-10)          calling :func:`initialize`
                                         (``init_process_group`` = the
                                         MPI_Init + rank exchange)
  MPI_Bcast scene/BVH chunks             :func:`replicate_scene`: the
  (server.cpp:90-164)                    scene's layout, then every
                                         tensor, broadcast from rank 0
  rank 0 relays tiles to the client      the frame's slices all-gathered
  (server.cpp:389-401)                   (``mesh.render_frame_sharded``)
  heterogeneous x86/PPC byte swap        N/A: one ISA

A single process needs none of this: :func:`initialize` does nothing
unless a multi-process environment is configured, and
:func:`global_mesh` is then the trivial mesh. The backend follows the
device the caller asks for: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import resolve_device
from .mesh import Mesh, make_mesh, render_frame_sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> bool:
    """Join (or skip) the process group.

    Arguments default to the ``SNAIL_COORD`` / ``SNAIL_NPROCS`` /
    ``SNAIL_PROC_ID`` environment variables (the mpirun-style launch:
    every process runs the same program with its rank in the environment,
    reference node.sh:1-7). ``SNAIL_COORD`` is ``host:port`` (a TCP store
    on rank 0) or any ``init_method`` URL (``file://...``). The backend is
    NCCL for ``device`` cuda, each process on card ``process_id`` modulo
    the cards it sees, and gloo for cpu; a failed NCCL start raises.
    Returns True when a multi-process group was joined (or had been),
    False for the single process."""
    if is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "SNAIL_COORD")
    if num_processes is None and "SNAIL_NPROCS" in os.environ:
        num_processes = int(os.environ["SNAIL_NPROCS"])
    if process_id is None and "SNAIL_PROC_ID" in os.environ:
        process_id = int(os.environ["SNAIL_PROC_ID"])

    if coordinator_address is None and num_processes is None:
        return False  # single process
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process launch needs the coordinator's "
                         "address, the process count and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh over every process's device (the MPI world communicator),
    or its first ``n_devices``: one device per process, so this is
    ``mesh.make_mesh``."""
    return make_mesh(n_devices)


def _device(group) -> torch.device:
    """The device a rank holds what it receives over ``group`` on: its
    card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _Slot:
    """A tensor's place in a scene's layout: its shape and dtype."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _layout(x, tensors: list):
    """``x`` (a scene, or a field of one) with each tensor replaced by its
    :class:`_Slot`, the tensors appended to ``tensors`` in order."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return _Slot(x)
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{k: _layout(getattr(x, k), tensors)
                          for k in x.__dataclass_fields__})
    return x


def _fill(x, tensors, device):
    """A layout with a new tensor on ``device`` in each slot."""
    if isinstance(x, _Slot):
        tensors.append(torch.empty(x.shape, dtype=x.dtype, device=device))
        return tensors[-1]
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{k: _fill(getattr(x, k), tensors, device)
                          for k in x.__dataclass_fields__})
    return x


def replicate_scene(scene, mesh: Mesh):
    """Rank 0's scene on every rank of the mesh, the BVH / material /
    texture broadcast (SendBVH + SendMatDescs + SendTexDict,
    server.cpp:90-164): rank 0 broadcasts the scene's layout (every
    field, each tensor as its shape and dtype), then each tensor; the
    other ranks may pass None. On the trivial mesh, and on a rank outside
    the mesh, ``scene`` is returned as it is."""
    if mesh.group is None or mesh.rank is None:
        return scene
    tensors = []
    layout = [_layout(scene, tensors) if mesh.rank == 0 else None]
    dist.broadcast_object_list(layout, src=0, group=mesh.group,
                               device=_device(mesh.group))
    if mesh.rank == 0:
        for t in tensors:
            dist.broadcast(t.contiguous(), src=0, group=mesh.group)
        return scene
    out = _fill(layout[0], tensors, _device(mesh.group))
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)
    return out


def render_frame_multihost(scene, camera, width: int, height: int, opts,
                           mesh: Optional[Mesh] = None) -> np.ndarray:
    """Render with the rays split over the mesh (default: every process);
    return the full frame on every rank as a host NumPy array (the
    reference's node->server tile relay + client reassembly,
    server.cpp:389-401, client.cpp:307-333)."""
    img = render_frame_sharded(scene, camera, width, height, opts,
                               mesh or global_mesh())
    return img.detach().cpu().numpy()


def _from_rank0(x: float) -> float:
    """Rank 0's value of ``x`` on every process of the world."""
    if not is_initialized():
        return x
    t = torch.tensor([x], dtype=torch.float64,
                     device=_device(dist.group.WORLD))
    dist.broadcast(t, src=0)
    return float(t[0])


def scaling_report(scene, camera, width: int, height: int, opts,
                   device_counts: Sequence[int], frames: int = 4,
                   rays_per_pixel: int = 2):
    """MRays/s at each device count + parallel efficiency, the rebuild of
    the reference's node-scaling tables (benchmark.txt:76-129): rank 0's
    seconds a frame of ``render_frame_sharded`` over ``frames`` frames
    after one warm-up, on every rank. Counts above the number of
    processes are skipped.

    Returns a list of dicts: {devices, ms, mrays, efficiency}."""
    rows = []
    base = None
    for n in device_counts:
        if n > process_count():
            continue
        mesh = global_mesh(n)
        s = replicate_scene(scene, mesh)
        dt = 0.0
        if mesh.rank is not None:
            img = render_frame_sharded(s, camera, width, height, opts, mesh)
            _wait(img)
            t0 = time.perf_counter()
            for _ in range(frames):
                img = render_frame_sharded(s, camera, width, height, opts,
                                           mesh)
            _wait(img)
            dt = (time.perf_counter() - t0) / frames
        dt = _from_rank0(dt)
        mrays = width * height * rays_per_pixel / dt / 1e6
        if base is None:
            base = (n, mrays)
        rows.append({
            "devices": n,
            "ms": round(dt * 1e3, 2),
            "mrays": round(mrays, 2),
            "efficiency": round(mrays / (base[1] * n / base[0]), 3),
        })
    return rows


def _wait(img: torch.Tensor) -> None:
    if img.device.type == "cuda":
        torch.cuda.synchronize(img.device)
