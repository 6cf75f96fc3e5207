"""Differentiable traversal (``snail_tpu.diff.vjp``).

Which triangle a ray hits is piecewise constant, so the traversal runs
without gradients (the kernels, through the dispatch seam), and the hit's
distance and barycentrics are recomputed in closed form from the rays and
the primal triangle arrays (``ops.intersect.intersect_dist_bary``): one
gather and a few dozen operations per ray, through which autograd gives
the exact gradients with respect to the vertices and the ray.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG
from ..ops import dispatch
from ..ops.intersect import intersect_dist_bary
from ..utils import trace


def diff_closest_hit(scene, orig, dirn, tmax):
    """Closest hit of rays ``orig``/``dirn`` (R, 3) with gradients to
    ``scene.tri_a``/``tri_ba``/``tri_ca`` and the rays: (dist, tri, bary
    (R, 2)) as :func:`ops.dispatch.closest_hit` gives them, dist and bary
    recomputed where the ray hits, tri without gradient."""
    with torch.no_grad():
        dist0, tri, bary0 = dispatch.closest_hit(
            scene, orig.detach(), dirn.detach(), tmax.detach())
    hit = (dist0 > 0.0) & (dist0 < BIG)
    d, u, v = intersect_dist_bary(orig, dirn, scene.tri_a, scene.tri_ba,
                                  scene.tri_ca, torch.where(hit, tri, 0),
                                  mask=hit)
    dist = torch.where(hit, d, dist0)
    bary = torch.where(hit[:, None], torch.stack([u, v], -1), bary0)
    return dist, tri, bary


def _flatten(tree):
    """The tensors of ``tree`` (a tensor, or a dict, list or tuple of
    trees) in order, and a function that rebuilds the tree from a list of
    as many."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"not a tensor, dict, list or tuple: {type(tree)}")
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(xs):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(xs[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for leaves, _ in parts for x in leaves], rebuild


def render_loss_and_grads(render_fn, params, loss_fn):
    """The value of ``loss_fn(render_fn(params))`` and its gradient with
    respect to every tensor of ``params`` (a tensor, or a dict, list or
    tuple of them, nested), in the same structure: the JAX package's
    ``jax.value_and_grad`` of it, on ``torch.autograd``. A tensor the loss
    does not depend on gets zeros; ``params`` themselves are not changed."""
    flat, rebuild = _flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with trace.span("snail.forward"):
        loss = loss_fn(render_fn(rebuild(leaves)))
    with trace.span("snail.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), rebuild([torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])
