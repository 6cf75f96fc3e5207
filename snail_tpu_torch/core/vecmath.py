"""Vector math on tensors and the constants shared by the port
(``snail_tpu.core.vecmath``). Every function takes the last axis as the
xyz component axis and broadcasts over the leading ones."""

import torch

# Large-but-finite stand-in for +inf where inf would poison arithmetic
# (0 * inf = nan): the miss distance and the masked-ray sentinel.
BIG = 3.4e37

# Bias of the inverse ray direction, 1 / (d + INV_EPS): the reference's
# SafeInv (rtbase.h:117-120), as every traversal kernel computes it.
INV_EPS = 1e-8


def dot(a, b):
    """Dot product over the last axis."""
    return (a * b).sum(-1)


def vdot(a, b):
    """Dot product keeping the reduced axis, for broadcasting."""
    return (a * b).sum(-1, keepdim=True)


def cross(a, b):
    """Cross product over the last axis."""
    return torch.linalg.cross(a, b)


def length(v):
    return torch.sqrt(dot(v, v))


def rsqrt_rn(x):
    """Correctly rounded float32 1/sqrt (the kernels use __frsqrt_rn)."""
    return torch.rsqrt(x.double()).float()


def normalize(v):
    """v * rsqrt(v . v), as the reference normalizes a ray
    (ray_generator.cpp:41-44), with the kernels' correctly rounded
    rsqrt."""
    return v * rsqrt_rn(vdot(v, v))


def safe_inv(v):
    """1 / (v + INV_EPS): a reciprocal that keeps axis-aligned rays finite
    (the reference's SafeInv)."""
    return 1.0 / (v + INV_EPS)


def reflect(d, n):
    """``d`` mirrored about the normal ``n``."""
    return d - 2.0 * vdot(d, n) * n


def refract(d, n, eta):
    """Snell refraction of the unit direction ``d`` through the unit normal
    ``n`` at relative index ``eta``; total internal reflection where there
    is no refracted ray."""
    cos_i = -vdot(d, n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return torch.where(sin2_t > 1.0, reflect(d, n), refr)
