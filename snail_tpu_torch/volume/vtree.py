"""Min/max-brick volume march (``snail_tpu.volume.vtree``, the reference's
``VTree``, src/vtree.h:7-45, src/vtree.cpp).

The reference builds a min/max kd-tree over 4^3 bricks of u16 data and
marches scalar rays with empty-space skipping. The JAX package's shape of
the idea, kept here, is a dense min/max pyramid (level 0: 4^3-voxel
bricks, level 1: 16^3) read by every step of a march: each ray looks up
the brick and coarse maxima at its position and either steps to the exact
exit plane of an empty cell or takes a 0.5-voxel step with a trilinear
sample.

The march is one hand-written CUDA kernel on the card (``ops.march``, V1,
``csrc/volume.cu``); :func:`_march_plain` is its plain version, the JAX
package's ``lax.while_loop`` as a lockstep loop over every ray with the
same stopping rule, which the kernel equals bit for bit (ROADMAP C19 on
the mip mode's extra sample). Render modes (dicom_viewer.cpp,
vrender_opengl.cpp): ``iso``, the first crossing of a density threshold
shaded by its gradient under a headlight; ``mip``, the maximum intensity
along each ray.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.types import resolve_device
from ..ops.march import march
from .data import VolumeData

BRICK = 4  # reference brick size (vtree.h)
COARSE = BRICK * BRICK  # voxels a side of a coarse cell
FINE = 0.5  # the march's step in an occupied brick, in voxels


@dataclasses.dataclass(frozen=True)
class VTree:
    vol: torch.Tensor         # (D, H, W) float32 normalized density
    brick_max: torch.Tensor   # (D/4, H/4, W/4) float32
    brick_min: torch.Tensor
    coarse_max: torch.Tensor  # (D/16, H/16, W/16) float32
    shape: Tuple[int, int, int]

    @property
    def device(self) -> torch.device:
        return self.vol.device

    def to(self, device) -> "VTree":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device)
            for k in ("vol", "brick_max", "brick_min", "coarse_max")})


def _pool_minmax(a: np.ndarray, k: int):
    d, h, w = a.shape
    pd, ph, pw = (-d) % k, (-h) % k, (-w) % k
    amax = np.pad(a, ((0, pd), (0, ph), (0, pw)), constant_values=0)
    amin = np.pad(a, ((0, pd), (0, ph), (0, pw)), constant_values=1e9)
    r = amax.reshape(amax.shape[0] // k, k, amax.shape[1] // k, k,
                     amax.shape[2] // k, k)
    rmin = amin.reshape(r.shape)
    return r.max(axis=(1, 3, 5)), rmin.min(axis=(1, 3, 5))


def build_vtree(vd: VolumeData, device="cuda") -> VTree:
    """The min/max pyramid (the VTree construction, vtree.cpp), built on
    the host as the JAX package builds it and moved to ``device``."""
    device = resolve_device(device)
    vol = vd.data.astype(np.float32) / 65535.0
    bmax, bmin = _pool_minmax(vol, BRICK)
    cmax, _ = _pool_minmax(bmax, BRICK)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return VTree(vol=dev(vol), brick_max=dev(bmax), brick_min=dev(bmin),
                 coarse_max=dev(cmax), shape=tuple(vol.shape))


def _corners(p, shape):
    """The trilinear taps of voxel-space positions p (R, 3) (zyx): their
    flat voxel indices (R, 2, 2, 2), clamped to the volume, and the
    fractions (R, 3). (One batched op per step of the index arithmetic,
    where a loop over the 8 corners would launch 8 times as many.)"""
    q = p - 0.5
    q0 = torch.floor(q)
    f = q - q0
    # int64: a volume may hold more than 2^31 voxels (V1 indexes in size_t)
    q0 = q0.to(torch.int64)
    top = torch.tensor([n - 1 for n in shape], dtype=torch.int64,
                       device=p.device)
    # (R, 3, 2): each axis's two taps, clamped
    ij = torch.minimum(torch.clamp_min(torch.stack([q0, q0 + 1], -1), 0),
                       top[:, None])
    _, h, w = shape
    zy = ij[:, 0, :, None] * h + ij[:, 1, None, :]
    return zy[:, :, :, None] * w + ij[:, 2, None, None, :], f


def _sample(vol, p, shape):
    """Trilinear density at voxel-space positions p (R, 3) (zyx), the taps
    clamped: the JAX package's lerps in x, then y, then z, each
    ``a * (1 - f) + b * f``."""
    idx, f = _corners(p, shape)
    c = vol.reshape(-1)[idx]  # (R, z, y, x)
    fz, fy, fx = (f[:, k, None, None] for k in range(3))
    c = c[..., 0] * (1 - fx) + c[..., 1] * fx  # (R, z, y)
    c = c[..., 0] * (1 - fy[..., 0]) + c[..., 1] * fy[..., 0]  # (R, z)
    return c[:, 0] * (1 - fz[:, 0, 0]) + c[:, 1] * fz[:, 0, 0]


def _cell_lookup(table, p, shape, cell):
    """The entries of ``table`` (one per ``cell``^3 voxels) at p (R, 3):
    trunc(p / cell) per axis, clamped to the table."""
    top = torch.tensor([(n + cell - 1) // cell - 1 for n in shape],
                       dtype=torch.int32, device=p.device)
    i = torch.minimum(torch.clamp_min((p / cell).to(torch.int32), 0), top)
    _, th, tw = table.shape
    return table.reshape(-1)[((i[:, 0] * th + i[:, 1]) * tw + i[:, 2])
                             .long()]


def _exit_dist(p, dirn, cell):
    """Distance along dirn from p to the exit plane of its ``cell``-voxel
    grid cell, plus 1e-2 so the next step lands inside the neighbour (the
    reference computes exact per-node t intervals, vtree.cpp:147-181)."""
    ib = torch.floor(p / cell)
    nxt = (ib + (dirn > 0.0)) * cell
    tiny = torch.abs(dirn) < 1e-9
    safe = torch.where(tiny, torch.where(dirn >= 0, 1e-9, -1e-9), dirn)
    tax = torch.where(tiny, 1e30, (nxt - p) / safe)
    return torch.clamp_min(tax.min(dim=1).values, 0.0) + 1e-2


def _march_step(vt: VTree, o, dirn, t1, iso: float, mode: str, state):
    """One step of the march's body (JAX ``_march``'s ``body``) on every
    ray, done or not: ``state`` (t, done, best, hit_t) -> the next state
    and, for who reads what a step needs, its positions p and the rays
    that sampled.

    It skips to the exact exit plane of the current coarse (16^3) or fine
    (4^3) cell when its maximum cannot beat the threshold (iso) or the
    current best (mip), else takes a 0.5-voxel step with a trilinear
    sample; in iso mode a brick whose minimum reaches the threshold is
    accepted without the sample."""
    shape = vt.shape
    t, done, best, hit_t = state
    p = o + dirn * t[:, None]
    bmax = _cell_lookup(vt.brick_max, p, shape, BRICK)
    cmax = _cell_lookup(vt.coarse_max, p, shape, COARSE)
    brick_exit = _exit_dist(p, dirn, BRICK)
    coarse_exit = _exit_dist(p, dirn, COARSE)
    if mode == "iso":
        bmin = _cell_lookup(vt.brick_min, p, shape, BRICK)
        sampled = bmax >= iso
        rho = torch.where(sampled, _sample(vt.vol, p, shape), 0.0)
        newly = ~done & sampled & ((rho >= iso) | (bmin >= iso))
        hit_t = torch.where(newly & (hit_t < 0), t, hit_t)
        done = done | newly
        step = torch.where(sampled, FINE, torch.where(
            cmax < iso, coarse_exit, brick_exit))
    else:  # mip
        sampled = bmax > best
        rho = torch.where(sampled, _sample(vt.vol, p, shape), 0.0)
        best = torch.maximum(best, rho)
        step = torch.where(sampled, FINE, torch.where(
            cmax <= best, coarse_exit, brick_exit))
    t = torch.where(done, t, t + step)
    done = done | (t >= t1)
    return (t, done, best, hit_t), p, sampled


def _march_start(t0, t1):
    """The march's first state (t, done, best, hit_t) over rays clipped
    to [t0, t1]."""
    r = t0.shape[0]
    return (torch.clamp_min(t0, 0.0), t0 > t1,
            torch.zeros(r, dtype=torch.float32, device=t0.device),
            torch.full((r,), -1.0, dtype=torch.float32, device=t0.device))


def _march_plain(vt: VTree, o, dirn, t0, t1, iso: float, mode: str,
                 max_steps: int):
    """The march (JAX ``_march``, vtree.py:115-172) as a lockstep loop over
    all rays: o/dirn (R, 3) in voxel space (zyx), t0/t1 (R,) the ray's
    clip against the volume, in voxel units. The loop runs while some ray
    is not done and fewer than ``max_steps`` steps were taken, and every
    step of the body (:func:`_march_step`) runs on every ray, as the JAX
    loop's does. Returns (best, hit_t) (R,): the mip mode's maximum, the
    iso mode's first crossing (-1 where none)."""
    state = _march_start(t0, t1)
    k = 0
    while k < max_steps and bool((~state[1]).any()):
        state, _, _ = _march_step(vt, o, dirn, t1, iso, mode, state)
        k += 1
    return state[2], state[3]


def _entry_exit(o, dirn, shape):
    """Ray/box clip against the volume bounds [0, shape] (voxel space):
    (max(t_near, 0), t_far)."""
    hi = torch.tensor(shape, dtype=torch.float32, device=o.device)
    idir = 1.0 / torch.where(torch.abs(dirn) < 1e-9, 1e-9, dirn)
    ta = (0.0 - o) * idir
    tb = (hi[None] - o) * idir
    tn = torch.minimum(ta, tb).max(dim=1).values
    tf = torch.maximum(ta, tb).min(dim=1).values
    return torch.clamp_min(tn, 0.0), tf


def volume_rays(vt: VTree, camera, width: int, height: int):
    """The primary rays of a width x height frame in voxel space (camera
    xyz -> volume zyx) and their clip: (o, d, t0, t1)."""
    from ..render.raygen import primary_rays

    origin, dirs = primary_rays(camera, width, height)
    d = dirs.reshape(-1, 3).flip(-1).contiguous()
    o = origin.flip(-1).expand_as(d)  # one origin, stride 0
    t0, t1 = _entry_exit(o, d, vt.shape)
    return o, d, t0, t1


def render_volume(vt: VTree, camera, width: int, height: int,
                  iso: float = 0.05, mode: str = "iso",
                  max_steps: int = 2048) -> torch.Tensor:
    """Render the volume through ``camera`` (world = voxel space, the
    volume spanning [0, shape]): (height, width, 3) float32 on the
    volume's device. The march runs V1 on the card (``ops.march``)."""
    if mode not in ("iso", "mip"):
        raise ValueError(f"mode {mode!r}: iso or mip")
    o, d, t0, t1 = volume_rays(vt, camera, width, height)
    best, hit_t = march(vt, o, d, t0, t1, iso, mode, max_steps)
    if mode == "mip":
        img = torch.stack([best] * 3, -1)
        return img.reshape(height, width, 3) * (
            1.0 / torch.clamp_min(best.max(), 1e-6))
    hit = hit_t >= 0.0
    p = o + d * torch.where(hit, hit_t, 0.0)[:, None]

    # gradient normal (central differences), headlight shade
    def g(axis):
        dp = torch.zeros((1, 3), dtype=torch.float32, device=p.device)
        dp[0, axis] = 1.0
        return _sample(vt.vol, p + dp, vt.shape) - _sample(vt.vol, p - dp,
                                                           vt.shape)

    n = torch.stack([g(0), g(1), g(2)], -1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1,
                                                     keepdim=True), 1e-9)
    ndl = torch.abs((n * d).sum(-1))
    shade = torch.where(hit, 0.1 + 0.9 * ndl, 0.0)
    img = torch.stack([shade, shade * 0.95, shade * 0.9], -1)
    return img.reshape(height, width, 3)
