"""The warps of B9b and of B2 (B8a) simulated on city_scene(24) at leaf
16, the bench city's tree: ``traverse_ref.shadow_sim`` (B9b on node
tables: the raw rows from the light, each warp's walk and its exit once
every live lane is blocked) against the plain B9b and the JAX package's
``any_hit_shared`` on the same scene with its leaf tables cleared (B9 in
interpret mode), and ``traverse.camera_wl_sim`` (B2's word scan, its kept
leaves in order) against the plain B2; each tally against its counters
and verdicts. The tallies are what chip_smoke.py's ``scan`` lines print
for the 1024 x 1024 wavefronts."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Light as JLight
from snail_tpu.ops import traverse_pallas as tp
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.ops.traverse_ref import shadow_sim, walk_shadow_plain
from snail_tpu_torch.scene.scene import traced_scene_from_numpy

LIGHT = np.array([0.0, 30.0, 0.0], np.float32)
FIELDS = ("node_lo", "node_hi", "node_child", "node_count", "node_axis",
          "node_first", "tri_a", "tri_ba", "tri_ca", "sh_mat", "sh_pack",
          "mat_pack", "mat_diffuse", "mat_specular", "mat_reflect",
          "mat_dissolve")
NO_WL = dict(wl_boxrows=None, wl_lfc=None, lf_boxv=None)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The warp simulations here are Python loops of small tensor ops. On
    a machine whose cores other test workers keep busy, PyTorch's
    intra-op thread pool makes each of them wait (a simulation took over
    200 s there against 3 s on one thread), so they run on one thread;
    the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def city24():
    """city_scene(24) at leaf 16 lit by the bench light: the JAX scene with
    its leaf tables cleared (its any-hit takes the interval walk), and
    the port's scene from its arrays with leaf tables and with node
    tables."""
    g = jproc.city_scene(24).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=16)
    js = j_make_traced_scene(g, bvh,
                             lights=JLight.make(LIGHT, (1.0, 1.0, 1.0), 120.0))
    arrays = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    js = dataclasses.replace(js, **NO_WL)
    assert not tp._wl_available(js)
    return (js, traced_scene_from_numpy(arrays, device="cpu"),
            traced_scene_from_numpy(arrays, device="cpu", walk=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_shadow_sim_matches_plain_and_jax(city24):
    """B9b's warps simulated (``shadow_sim``) on a packet of rays from the
    bench light toward seeded points of the city's lower third (every
    61st masked): the verdicts are the plain B9b's bit for bit and the
    JAX package's ``any_hit_shared``'s (B9 in interpret mode) on > 0.999
    of the live rays, as tests/test_torch_walk.py holds them; the tally
    holds against B9f's counters (node steps, leaf visits, the most rows
    a lane tested) and the verdicts (each blocked ray blocked in one
    visit), and the visits by entering lanes sum to the visits."""
    js, _, walk = city24
    rng = np.random.default_rng(41)
    lo, hi = walk.root_lo.numpy(), walk.root_hi.numpy()
    tgt = rng.uniform(lo, hi, (pt.PACKET_R, 3))
    tgt[:, 1] = rng.uniform(lo[1], lo[1] + 0.3 * (hi[1] - lo[1]),
                            pt.PACKET_R)
    d = tgt - LIGHT
    ld = np.linalg.norm(d, axis=-1)
    d = (d / ld[:, None]).astype(np.float32)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::61] = -BIG
    pk = lambda a: _t(a).reshape(1, pt.PACKET_R)
    planes = tuple(pk(d[:, k]) for k in range(3))
    rows = walk.tri_rows
    blocked, stats, tally = shadow_sim(_t(LIGHT), planes, pk(tm), rows,
                                       walk.nodes)
    assert torch.equal(blocked, walk_shadow_plain(_t(LIGHT), planes, pk(tm),
                                                  rows, walk.nodes))
    jb = np.asarray(tp.any_hit_shared(
        js, jnp.asarray(LIGHT), tuple(jnp.asarray(d[:, k]) for k in range(3)),
        jnp.asarray(tm)))
    pb = blocked.reshape(-1).numpy() > 0
    live = tm >= 0
    assert not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    assert (pb[live] == jb[live]).mean() > 0.999
    t = dict(zip(pt.TALLY, tally))
    assert tally.shape == (len(pt.TALLY), pt.WARPS)
    assert int(t["nodes"].sum()) == int(stats[0, 0])
    assert int(t["visits"].sum()) == int(stats[0, 2])
    assert int(t["most"].sum()) == int(stats[0, 3])
    assert torch.equal(sum(t[b] for b in pt.LANE_BINS), t["visits"])
    assert ((t["visits"] <= t["lanes"])
            & (t["lanes"] <= pt.WARP * t["visits"])).all()
    assert ((t["lanes"] <= t["tested"]) & (t["tested"] <= t["lane_rows"])
            & (t["most"] <= t["rows"]) & (t["blocked"] <= t["lanes"])).all()
    assert int(t["blocked"].sum()) == int(pb[live].sum())
    assert int(t["chunk2"].sum()) == 0
    # both ways of testing a leaf occur: few lanes and many
    assert int(t["1"].sum()) > 0 and int(t["17-32"].sum()) > 0


def test_camera_wl_sim_matches_plain(city24):
    """B2's warps simulated (``camera_wl_sim``) on the 128 x 128 primary
    wavefront: dist, u, v and tri the plain B2's, bit for bit where the
    triangle agrees and a distance tie where it does not (the plain
    version takes the lowest id, the kernel the first of its scan), the
    directions bit for bit; the tally holds against the counters (the
    plain B8a's) (words at the leaf level, leaf visits, the most rows a
    lane tested, visits at most the leaves kept), every entering lane
    tests its leaf's rows, and the visits by entering lanes sum to the
    visits."""
    _, leaf, _ = city24
    w = h = 128
    lo, hi = leaf.root_lo.numpy(), leaf.root_hi.numpy()
    c, ext = (lo + hi) * 0.5, float(np.max(hi - lo))
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                         target=tuple(c), device="cpu")
    cv, words, summ, floors = pt._camera_words(leaf, cam, w, h)
    rows = leaf.tri_rows
    pids = torch.arange(words.shape[0])
    out, stats, tally = pt.camera_wl_sim(cv, w, h, rows, leaf.leaves, words,
                                         floors, pids)
    plain = pt.camera_wl_plain(cv, w, h, rows, leaf.leaves, words, pids)
    assert all(torch.equal(a, b) for a, b in zip(out[4:], plain[4:]))
    same = out[3] == plain[3]
    assert all(torch.equal(a[same], b[same])
               for a, b in zip(out[:3], plain[:3]))
    torch.testing.assert_close(out[0][~same], plain[0][~same], rtol=1e-5,
                               atol=0.0)
    assert float((out[0] < BIG).float().mean()) > 0.3
    t = dict(zip(pt.TALLY, tally))
    packet = lambda x: x.reshape(-1, pt.WARPS).sum(1)
    assert torch.equal(packet(t["nodes"]), stats[:, 0].long())
    assert torch.equal(packet(t["visits"]), stats[:, 2].long())
    assert torch.equal(packet(t["most"]), stats[:, 3].long())
    assert (packet(t["visits"]) <= stats[:, 1].long()).all()
    assert torch.equal(sum(t[b] for b in pt.LANE_BINS), t["visits"])
    assert ((t["visits"] <= t["lanes"])
            & (t["lanes"] <= pt.WARP * t["visits"])).all()
    assert torch.equal(t["tested"], t["lane_rows"])
    assert int(t["blocked"].sum()) == 0 == int(t["chunk2"].sum())
    assert int(t["1"].sum()) > 0 and int(t["17-32"].sum()) > 0


def test_camera_wl_order_is_eight_by_four_tiles():
    """B2's (B8a's) warp footprint: ``camera_wl_order`` is a permutation
    of a packet's rays, and each warp's 32 lanes cover an 8 x 4 block of
    pixels, lane l at (l % 8, l // 8) of it, 8 rows of 4 tiles a
    quarter."""
    order = pt.camera_wl_order()
    assert torch.equal(torch.sort(order).values, torch.arange(pt.PACKET_R))
    px, py = pt._pixel_xy(pt.TILE, pt.TILE, torch.arange(1), "cpu")
    px, py = (c[0][order].reshape(pt.WARPS, pt.WARP) for c in (px, py))
    lane = torch.arange(pt.WARP)
    assert torch.equal(px - px[:, :1], (lane % 8).expand_as(px))
    assert torch.equal(py - py[:, :1], (lane // 8).expand_as(py))
    corners = set(zip(px[:, 0].tolist(), py[:, 0].tolist()))
    assert corners == {(x, y) for x in range(0, pt.TILE, 8)
                       for y in range(0, pt.TILE, 4)}
