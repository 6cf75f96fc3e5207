"""Rendering and training over several GPUs with ``torch.distributed``
(``snail_tpu.parallel.mesh``), the rebuild of the reference's
distributed layer (SURVEY.md §2.4-2.5).

One process drives one device, so a mesh of n devices is a process group
of n ranks (:func:`make_mesh`). The mapping from the reference's MPI
architecture:

  reference                              ->  here
  ---------------------------------------------------------------------
  DivideImage into 16x64 parts +            each rank renders one
  static assignment to nodes                contiguous slice of the
  (server.cpp:178-190, 233-265)             frame's wavefront, whole
                                            tiles where they divide
  full BVH broadcast to every node          ``distributed.replicate_scene``
  (SendBVH server.cpp:144-164)              (every tensor from rank 0)
  compressed tile relay node->server->      ``all_gather_into_tensor`` of
  client (server.cpp:389-401)               the slices' colours
  (north star) gradient all-reduce          ``all_reduce`` (sum) of each
                                            gradient and of the loss

With no process group, :func:`make_mesh` gives the trivial mesh of this
process alone, on which no collective runs. A rank holds its scene and
its rays on its own device; the collectives run on the group's backend
(NCCL between cards, gloo between CPU processes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..core.types import Camera, RenderOpts
from ..render.integrator import render_wavefront
from ..render.raygen import tile_rays, untile_image
from ..render.renderer import frame_rays


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the rays: ``size`` ranks of the process group
    ``group`` (None: the trivial mesh of this process alone), and this
    process's rank in it (None: this process is not a member)."""

    group: Optional[object]
    size: int
    rank: Optional[int]


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the first ``n_devices`` ranks of the process group
    (None: all of them), one device each; without a process group, the
    trivial mesh (``n_devices`` None or 1). A group of fewer ranks than
    the world is made with ``new_group``, which every rank must call."""
    if not _joined():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs a "
                             "process group of as many ranks")
        return Mesh(None, 1, 0)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a world of {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    return Mesh(group, n, rank if rank < n else None)


def shard_rays(mesh: Mesh, *arrays):
    """This rank's contiguous slice of each (R, ...) wavefront array (the
    rays a reference node renders). R must divide by the mesh's size, as
    ``shard_map`` requires of the JAX package's."""
    if mesh.rank is None:
        raise ValueError("this process is not a member of the mesh")
    out = []
    for x in arrays:
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rays do not divide over "
                             f"{mesh.size} devices")
        k = x.shape[0] // mesh.size
        out.append(x[mesh.rank * k:(mesh.rank + 1) * k])
    return tuple(out)


def _frame_rays(camera: Camera, width: int, height: int, supersample):
    """The frame's primary wavefront (at twice the size when
    supersampling) as ``render_frame_portable`` builds it."""
    scale = 2 if supersample else 1
    w, h = width * scale, height * scale
    o, d, tmax, (th, tw) = frame_rays(camera, w, h)
    return o, d, tmax, (w, h, th, tw)


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' slices ``x`` stacked in rank order, on every rank."""
    if mesh.group is None:
        return x
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out


def render_frame_sharded(scene, camera: Camera, width: int, height: int,
                         opts: RenderOpts, mesh: Mesh) -> torch.Tensor:
    """The full (height, width, 3) frame on every rank of the mesh, each
    rank tracing its contiguous slice of the primary wavefront through the
    portable integrator (``render_wavefront``, the frame of
    ``render_frame_portable``) on its scene's device, the colours
    all-gathered. Slices fall on tile boundaries whenever the tiles divide
    over the mesh (any power-of-two frame), so the primary hits keep
    their uv footprint; otherwise they get none (mip 0). Raises
    ValueError if the rays do not divide over the mesh."""
    o, d, tmax, (w, h, th, tw) = _frame_rays(camera, width, height,
                                             opts.supersample)
    tiled = (w * h) % (mesh.size * th * tw) == 0
    o, d, tmax = shard_rays(mesh, o, d, tmax)
    color = render_wavefront(scene, o, d, tmax, opts,
                             tile_hw=(th, tw) if tiled else None)
    color = _all_gather(mesh, color)
    img = untile_image(color.reshape(-1, th * tw, 3), h, w, th, tw)
    if opts.supersample:
        img = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
               + img[1::2, 1::2]) * 0.25
    return img


def train_step_sharded(scene, params: dict, target: torch.Tensor,
                       camera: Camera, width: int, height: int,
                       opts: RenderOpts, mesh: Mesh, lr: float = 1e-3):
    """One differentiable-render training step over the mesh.

    ``params`` maps scene fields to their values (e.g. {"tri_a": ..,
    "mat_diffuse": ..}). Each rank renders its slice of the frame with
    them and takes its slice's sum of squared differences to ``target``
    ((height, width, 3)) over the frame's element count, so that the sum
    over the ranks is the frame's L2 (mean squared) loss; the gradients
    (``torch.autograd.grad``) and the loss are summed over the mesh
    (``all_reduce``), then each parameter takes ``p - lr * g``. Returns
    (loss, new_params), the same on every rank."""
    o, d, tmax, (w, h, th, tw) = _frame_rays(camera, width, height,
                                             opts.supersample)
    tgt = tile_rays(target, th, tw).reshape(-1, 3)
    count = tgt.numel()
    o, d, tmax, tgt = shard_rays(mesh, o, d, tmax, tgt)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    color = render_wavefront(dataclasses.replace(scene, **leaves), o, d,
                             tmax, opts)
    loss = ((color - tgt) ** 2).sum() / count
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves.values(), grads)]
    loss = loss.detach()
    if mesh.group is not None:
        for t in (loss, *grads):
            dist.all_reduce(t, group=mesh.group)
    return loss, {k: (p - lr * g).detach()
                  for (k, p), g in zip(leaves.items(), grads)}
