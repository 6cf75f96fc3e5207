"""Camera, light and option records (``snail_tpu.core.types``).

The JAX package registers these as pytrees; here they are plain
dataclasses of tensors with a ``.to(device)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card by default. Kernels are
    routed by the device of their tensors, so a CPU run must be asked for
    (``device="cpu"``); asking for the card without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev


def _f32(x, device) -> torch.Tensor:
    device = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    # non-blocking: a copy to the card from pageable memory is staged when
    # it is queued, and a blocking one would wait for the work queued
    # before it (a render server builds a camera per frame)
    return torch.tensor(np.asarray(x, np.float32)).to(device,
                                                      non_blocking=True)


@dataclasses.dataclass(frozen=True)
class Rays:
    """A wavefront of rays: origin and dir float32 (..., 3), tmax float32
    (...), a negative tmax masking the ray (the reference's sentinel,
    ray_group.h:382)."""

    origin: torch.Tensor
    dir: torch.Tensor
    tmax: torch.Tensor

    @property
    def idir(self) -> torch.Tensor:
        from .vecmath import safe_inv

        return safe_inv(self.dir)

    @property
    def active(self) -> torch.Tensor:
        return self.tmax >= 0.0

    def count(self) -> int:
        return self.tmax.numel()


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera basis (reference src/camera.h:7-14).

    ``right``/``up``/``front`` are the unit view basis (float32 (3,)),
    ``plane_dist`` the focal distance in multiples of the image height."""

    pos: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    front: torch.Tensor
    plane_dist: torch.Tensor

    @staticmethod
    def look_at(pos, target, up=(0.0, 1.0, 0.0), plane_dist=1.0,
                device="cuda") -> "Camera":
        pos = _f32(pos, device)
        front = _f32(target, device) - pos
        front = front / torch.linalg.vector_norm(front)
        right = torch.linalg.cross(front, _f32(up, device))
        right = right / torch.linalg.vector_norm(right)
        true_up = torch.linalg.cross(right, front)
        return Camera(pos=pos, right=right, up=true_up, front=front,
                      plane_dist=_f32(plane_dist, device))

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class Light:
    """Point lights with radius falloff (reference src/light.h:6-18),
    batched: pos/color float32 (L, 3), radius float32 (L,)."""

    pos: torch.Tensor
    color: torch.Tensor
    radius: torch.Tensor

    @staticmethod
    def make(pos, color, radius, device="cuda") -> "Light":
        return Light(pos=torch.atleast_2d(_f32(pos, device)),
                     color=torch.atleast_2d(_f32(color, device)),
                     radius=torch.atleast_1d(_f32(radius, device)))

    @staticmethod
    def stack(lights) -> "Light":
        """Concatenate several Light records into one multi-light set."""
        return Light(pos=torch.cat([l.pos for l in lights]),
                     color=torch.cat([l.color for l in lights]),
                     radius=torch.cat([l.radius for l in lights]))

    def __len__(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "Light":
        return Light(pos=self.pos.to(device), color=self.color.to(device),
                     radius=self.radius.to(device))


@dataclasses.dataclass(frozen=True)
class RenderOpts:
    """Render options: the reference's ``gVals`` toggles (rtbase.h:31),
    with the fields and defaults of ``snail_tpu.core.types.RenderOpts``."""

    shading: bool = True
    reflections: bool = True
    transparency: bool = True
    shadows: bool = True
    textures: bool = True
    stats: bool = False
    supersample: bool = False
    max_bounces: int = 1
    photons: bool = False
    tex_filter: str = "point"
    ambient: float = 0.1
    photon_exposure: float = 1.0


__all__ = ["Camera", "Light", "Rays", "RenderOpts", "resolve_device"]
