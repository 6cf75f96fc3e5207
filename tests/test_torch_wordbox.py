"""The word and block boxes of the leaf tables (``LeafTables.wbox`` and
``bbox``) and the skips of B4/B6 and B5's word pre-test that rest on
them, in plain torch on the CPU: the boxes are the min/max of their real
leaves, every ray that enters a leaf before its limit enters the leaf's
word and block no later (with the kernels' float32 arithmetic), a leaf
that passes a packet's interval test lies in a word that passes it, the
counter simulation of B8b (``shadow_wl_stats_plain``, which follows
``scan_boxes``), and B8a's walked the same way, count what the word scan
counted, less the skipped words, and scenes with more leaves than the
words passes take get node tables."""

import numpy as np
import pytest
import torch

from test_torch_stats import _check_invariants

from snail_tpu_torch.bvh import build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG, INV_EPS
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.fast import (_shadow_rays, _surface,
                                         _toward_light,
                                         render_frame_fast_stats)
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.base_scene import BaseScene
from snail_tpu_torch.scene.scene import make_traced_scene

LIGHTS = {"city": ((0.0, 30.0, 0.0), 120.0),
          "terrain": ((-40.0, 10.0, 0.0), 200.0)}


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


def _build(kind, n):
    g = (pproc.city_scene if kind == "city" else pproc.terrain_scene)(n)
    g = g.flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    pos, r = LIGHTS[kind]
    scene = make_traced_scene(g, bvh, lights=Light.make(
        pos, (1.0, 1.0, 1.0), r, device="cpu"), device="cpu")
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                         target=tuple(c), device="cpu")
    return scene, cam


@pytest.fixture(scope="module", params=[("city", 8), ("terrain", 96)],
                ids=["city_8", "terrain_96"])
def scene(request):
    return _build(*request.param)


@pytest.fixture(scope="module")
def city4():
    """The city fixture of tests/test_torch_stats.py."""
    return _build("city", 4)


def _grouped(box, n_leaf, n):
    """The min/max over the real leaves of each run of n, in NumPy."""
    lp = box.shape[1]
    out = np.empty((6, lp // n), np.float32)
    for j in range(lp // n):
        real = np.arange(j * n, min((j + 1) * n, n_leaf))
        if len(real) == 0:
            out[:3, j], out[3:, j] = 1e30, -1e30
        else:
            out[:3, j] = box[:3, real].min(1)
            out[3:, j] = box[3:, real].max(1)
    return out


def test_word_and_block_boxes_are_min_max_of_real_leaves(scene):
    lt = scene[0].leaves
    box = lt.box.numpy()
    assert lt.wbox.dtype == lt.bbox.dtype == torch.float32
    assert lt.wbox.shape == (6, lt.lp // pt.WARP)
    assert lt.bbox.shape == (6, lt.lp // pt.LEAF_BLOCK)
    np.testing.assert_array_equal(lt.wbox.numpy(),
                                  _grouped(box, lt.n_leaf, pt.WARP))
    np.testing.assert_array_equal(lt.bbox.numpy(),
                                  _grouped(box, lt.n_leaf, pt.LEAF_BLOCK))
    # the words past the last real leaf are inverted, and there are some
    empty = np.arange(lt.lp // pt.WARP) * pt.WARP >= lt.n_leaf
    assert empty.any()
    assert (lt.wbox[:3, empty] == 1e30).all()
    assert (lt.wbox[3:, empty] == -1e30).all()


def test_terrain_has_several_blocks():
    lt = _build("terrain", 96)[0].leaves
    assert lt.n_leaf == 2879 and lt.lp // pt.LEAF_BLOCK >= 2


def test_leaf_tables_to_carries_the_boxes(scene):
    lt = scene[0].leaves
    meta = lt.to("meta")
    assert meta.wbox.device.type == meta.bbox.device.type == "meta"
    assert meta.wbox.shape == lt.wbox.shape
    assert meta.bbox.shape == lt.bbox.shape
    moved = lt.to("cpu")
    assert torch.equal(moved.wbox, lt.wbox)
    assert torch.equal(moved.bbox, lt.bbox)


def _rays(scene, kind, seed=3):
    """Seeded rays: ``bounce`` from their own origins near a point of the
    scene box in a cone (every 5th axis-aligned, so that one inverse
    direction is 1/INV_EPS), tmax BIG; ``shadow`` from the scene's light
    to points in the lower part of the box, tmax just short of them.
    Returns (o, d, tm): three (R,) or 0-d, three (R,), (R,)."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.numpy(), scene.root_hi.numpy()
    n = 4096
    if kind == "bounce":
        o = rng.uniform(lo, hi, (1, 3)) + rng.uniform(-0.05, 0.05, (n, 3)) * (
            hi - lo)
        d = rng.normal(size=(n, 3))
        d[::5, :2] = 0.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        tm = np.full(n, BIG)
        o = tuple(torch.from_numpy(o[:, k].astype(np.float32))
                  for k in range(3))
    else:
        light = scene.lights.pos[0].numpy()
        tgt = rng.uniform(lo, hi, (n, 3))
        tgt[:, 1] = rng.uniform(lo[1], lo[1] + 0.3 * (hi[1] - lo[1]), n)
        d = tgt - light
        ld = np.linalg.norm(d, axis=-1)
        d /= ld[:, None]
        tm = ld * 0.9999
        o = tuple(torch.tensor(light[k]) for k in range(3))
    d = tuple(torch.from_numpy(d[:, k].astype(np.float32)) for k in range(3))
    return o, d, torch.from_numpy(tm.astype(np.float32))


def _slab(box, o, idir):
    """(R, n) entry and pass of every ray against every box of the planar
    ``box`` (6, n), as the kernels' ray_slab."""
    tn, tf = pt._slab(
        [(box[k][None, :] - o[k].reshape(-1, 1)) * idir[k][:, None]
         for k in range(3)],
        [(box[3 + k][None, :] - o[k].reshape(-1, 1)) * idir[k][:, None]
         for k in range(3)])
    return tn, (tn <= tf) & (tf > 0.0)


@pytest.mark.parametrize("kind", ["bounce", "shadow"])
def test_a_ray_that_enters_a_leaf_enters_its_word_and_block(scene, kind):
    """The property that makes the skips of B4/B6 exact: every (ray, leaf)
    whose slab test passes with tn < tmax also passes its word's and its
    block's, with tn no larger."""
    sc, _ = scene
    lt = sc.leaves
    o, d, tm = _rays(sc, kind)
    idir = [1.0 / (c + INV_EPS) for c in d]
    assert all(bool(torch.isfinite(c).all()) for c in idir)
    n = lt.n_leaf
    tn, pas = _slab(lt.box[:, :n], o, idir)
    enter = pas & (tn < tm[:, None])
    assert int(enter.sum()) > 100
    for table, group in ((lt.wbox, pt.WARP), (lt.bbox, pt.LEAF_BLOCK)):
        gtn, gpas = _slab(table, o, idir)
        of = torch.arange(n) // group
        gtn, gpas = gtn[:, of], gpas[:, of]
        assert bool(gpas[enter].all())
        assert bool((gtn[enter] <= tn[enter]).all())


def _shadow_stats(scene, cam, w=128):
    """B8b's plain version on the frame's shadow rays toward light 0:
    (blocked, counters, words)."""
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, w, w)
    o3 = (cam.pos[0], cam.pos[1], cam.pos[2])
    hit, _, n3, p3 = _surface(scene, o3, (dx, dy, dz), dist, u, v, tri)
    lp = scene.lights.pos[0]
    fl3, ldist, _, mask = _toward_light(p3, n3, hit, lp)
    d3, tm = _shadow_rays(fl3, ldist, mask)
    orig, d, tm, _, words, summ, floors = pt._shared_planes(scene, lp, d3,
                                                            tm)
    rows = pt.shared_rows(scene.tri_rows, orig)
    blocked, stats = pt.shadow_wl_stats_plain(orig, d, tm, rows,
                                              scene.leaves, words, floors)
    return blocked, stats, words, (orig, d, tm, rows, words, floors)


def _word_scan_stats(monkeypatch, scene, args):
    """B8b's counters as the word scan (``scan_words``, every populated
    word at the leaf level) counted them before the skips."""
    sim = pt._scan_sim
    with monkeypatch.context() as m:
        m.setattr(pt, "_scan_sim", lambda *a: sim(*a[:7]))
        orig, d, tm, rows, words, floors = args
        return pt.shadow_wl_stats_plain(orig, d, tm, rows, scene.leaves,
                                        words, floors)


@pytest.mark.parametrize("which", ["city4", "terrain"])
def test_shadow_counters_with_skips(monkeypatch, city4, which):
    """B8b's simulation with the skips: the invariants of its counters;
    ``nodes`` and ``leaves`` no larger than the word scan's (on the
    terrain's three blocks, fewer), and the same leaves intersected, the
    same triangles tested and the same bands entered."""
    sc, cam = city4 if which == "city4" else _build("terrain", 96)
    blocked, stats, words, args = _shadow_stats(
        sc, cam, 128 if which == "city4" else 64)
    _check_invariants(stats, words)
    tm = args[2]
    assert 0.02 < float(blocked[tm >= 0].mean()) < 0.98
    old_blocked, old = _word_scan_stats(monkeypatch, sc, args)
    assert torch.equal(blocked, old_blocked)
    new, old = stats[:, :5].sum(0), old[:, :5].sum(0)
    assert new[0] <= old[0] and new[1] <= old[1]
    assert torch.equal(new[2:], old[2:])
    if which == "terrain":
        assert new[0] < old[0] // 2


def test_hand_counted_quad_under_a_light():
    """The quad of test_torch_stats.test_hand_counted_quad with a light
    at (0, 0, -4), toward which every pixel casts a live shadow ray: each
    ray ends 0.9999 of the way from the light to the quad, so every warp
    of the shadow packet enters its band and skips the quad's block,
    whose box lies beyond all of its rays (the word scan read the quad's
    word in each warp)."""
    base = BaseScene()
    base.objects.append(pproc._obj_from_tris(pproc._quad(
        (-10.0, -10.0, 0.0), (10.0, -10.0, 0.0), (10.0, 10.0, 0.0),
        (-10.0, 10.0, 0.0))))
    g = base.flatten()
    lo, hi = g.bounds()
    scene = make_traced_scene(g, build_bvh(lo, hi, leaf_size=8),
                              lights=Light.make((0.0, 0.0, -4.0),
                                                (1.0, 1.0, 1.0), 30.0,
                                                device="cpu"),
                              device="cpu")
    cam = Camera.look_at(pos=(0.5, -0.25, 5.0), target=(0.5, -0.25, 0.0),
                         device="cpu")
    img, st = render_frame_fast_stats(
        scene, cam, 64, 64,
        RenderOpts(reflections=False, transparency=False, textures=False))
    assert float(img.min()) > 0.0
    # the primary packet's 128/128/128/256/128 and the shadow packet's
    # 0/0/0/0/128
    assert st == {"nodes": 128, "leaves": 128, "quarters": 128,
                  "tri_blocks": 256, "chunks": 256, "rays": 2 * 64 * 64}


def _camera_stats(scene, cam, w):
    """B8a's plain version on a w x w frame's primary rays: (outputs,
    counters, words, its arguments)."""
    cv, words, summ, floors = pt._camera_words(scene, cam, w, w)
    rows = pt.shared_rows(scene.tri_rows, cam.pos)
    args = (cv, w, w, rows, scene.leaves, words, floors,
            torch.arange(words.shape[0]))
    *out, stats = pt.camera_wl_stats_plain(*args)
    return out, stats, words, args


@pytest.mark.parametrize("which", ["city4", "terrain"])
def test_camera_counters_with_skips(monkeypatch, city4, which):
    """B2/B8a scan with ``scan_words`` (on ``scan_boxes`` they were
    slower). B8a's simulation walked as B8b's is, with the block and word
    skips of ``scan_boxes`` on the primary rays (each lane's limit its
    current best): the invariants of both counters; ``nodes`` and
    ``leaves`` no larger than the word scan's (on the terrain's three
    blocks, fewer), and the same leaves intersected, the same triangles
    tested and the same bands entered, so the skips are exact on primary
    rays too."""
    sc, cam = city4 if which == "city4" else _build("terrain", 96)
    out, stats, words, args = _camera_stats(sc, cam,
                                            128 if which == "city4" else 64)
    _check_invariants(stats, words)
    sim = pt._scan_sim

    def with_skips(tables, words_p, floors_p, o, cull, bound_fn, leaf_fn,
                   **kw):
        # the lanes' inverse directions and bests that the leaf function
        # of camera_wl_sim reads and updates
        env = dict(zip(leaf_fn.__code__.co_freevars,
                       (c.cell_contents for c in leaf_fn.__closure__)))
        return sim(tables, words_p, floors_p, o, cull, bound_fn, leaf_fn,
                   lambda: (env["wi"], env["best"]), **kw)

    with monkeypatch.context() as m:
        m.setattr(pt, "_scan_sim", with_skips)
        # the outputs do not depend on the scan: only the counters are new
        m.setattr(pt, "camera_wl_plain", lambda *a, **k: out)
        *_, skip = pt.camera_wl_stats_plain(*args)
    _check_invariants(skip, words)
    new, old = skip[:, :5].sum(0), stats[:, :5].sum(0)
    assert new[0] <= old[0] and new[1] <= old[1]
    assert torch.equal(new[2:], old[2:])
    if which == "terrain":
        assert new[0] < old[0]


def _bounce_packets(sc, seeds=(3, 4, 5, 6)):
    """Seeded packets of bounce rays, one per seed: from within 5 % of the
    scene box's extent of a point in it, in a cone of half-width ~0.2 about
    a seeded axis, tmax BIG; in the packets of odd seeds every 5th ray runs
    along the axis's largest component, so that two of its inverse
    directions are 1/INV_EPS. Returns the (o, d, tm) planes, (len(seeds),
    PACKET_R)."""
    lo, hi = sc.root_lo.numpy(), sc.root_hi.numpy()
    o, d = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        o.append(rng.uniform(lo, hi, (1, 3)) + rng.uniform(
            -0.05, 0.05, (pt.PACKET_R, 3)) * (hi - lo))
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        dirs = axis + rng.uniform(-0.2, 0.2, (pt.PACKET_R, 3))
        if seed % 2:
            j = int(np.abs(axis).argmax())
            dirs[::5] = 0.0
            dirs[::5, j] = np.sign(axis[j])
        d.append(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    plane = lambda a, k: torch.from_numpy(
        np.stack(a)[..., k].astype(np.float32))
    return (tuple(plane(o, k) for k in range(3)),
            tuple(plane(d, k) for k in range(3)),
            torch.full((len(seeds), pt.PACKET_R), BIG))


def _shadow_packets(sc, seeds=(3, 4, 5, 6)):
    """Seeded packets of shadow rays, one per seed: from the scene's light
    to points within 20 % of the scene box's extent of a seeded point in
    the lower part of the box, tmax just short of them. Returns the (d, tm)
    planes, (len(seeds), PACKET_R)."""
    lo, hi = sc.root_lo.numpy(), sc.root_hi.numpy()
    light = sc.lights.pos[0].numpy()
    d, tm = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        c = rng.uniform(lo, hi)
        c[1] = rng.uniform(lo[1], lo[1] + 0.3 * (hi[1] - lo[1]))
        v = c + rng.uniform(-0.2, 0.2, (pt.PACKET_R, 3)) * (hi - lo) - light
        ld = np.linalg.norm(v, axis=-1)
        d.append(v / ld[:, None])
        tm.append(ld * 0.9999)
    return (*(torch.from_numpy(np.stack(d)[..., k].astype(np.float32))
              for k in range(3)),
            torch.from_numpy(np.stack(tm).astype(np.float32)))


def _fenced(planes):
    """The planes of packet 0 once more as a last packet, whose ray 0 has
    the x direction -INV_EPS: 1 / (d + INV_EPS) is +inf, so the interval's
    inverse-direction bound is not finite."""
    *o, dx, dy, dz, tm = planes
    fence = dx[:1].clone()
    fence[0, 0] = -INV_EPS
    return (*(torch.cat([c, c[:1]]) for c in o),
            torch.cat([dx, fence]), *(torch.cat([c, c[:1]])
                                      for c in (dy, dz, tm)))


def _mode_packets(sc, cam, mode):
    """Seeded packets of each origin mode, with the interval bounds of
    ``_leaf_pass``, the words whose box the kernels' pre-test passes, the
    plain words, and how many leading packets have finite bounds:
    camera, the 64 packets of a 512 x 512 frame; shared, the packets of
    ``_shadow_packets``; general, those of ``_bounce_packets``. Shared and
    general add the fence packet of ``_fenced`` (the camera's rays have no
    such direction)."""
    lt = sc.leaves
    if mode == "camera":
        w = 512
        cv = pt.cam_vec(cam, w, w, sc.root_lo, sc.root_hi)
        pids = torch.arange((w // pt.TILE) ** 2)
        return (pt._camera_bounds(cv, w, w, pids),
                pt.camera_word_tests(cv, w, w, lt, pids),
                pt.words_camera_plain(cv, w, w, lt, pt.WL_BANDS, pids)[0],
                len(pids))
    if mode == "shared":
        *d, tm = _fenced(_shadow_packets(sc))
        orig = sc.lights.pos[0]
        return (pt._shared_bounds(orig, d, tm),
                pt.shared_word_tests(orig, d, tm, lt),
                pt.words_shared_plain(orig, d, tm, lt, pt.WL_BANDS)[0],
                tm.shape[0] - 1)
    o, d, tm = _bounce_packets(sc)
    *o, dx, dy, dz, tm = _fenced((*o, *d, tm))
    d = (dx, dy, dz)
    return (pt._general_bounds(o, d, tm), pt.general_word_tests(o, d, tm, lt),
            pt.words_general_plain(o, d, tm, lt, pt.WL_BANDS)[0],
            tm.shape[0] - 1)


@pytest.mark.parametrize("mode", ["camera", "shared", "general"])
def test_a_leaf_that_passes_b5s_interval_test_has_a_word_that_passes(
        scene, mode):
    """The property that makes the word-box pre-test of the words passes
    (B1 camera, B3 shared origin, B5 per-ray origins: one origin and two
    products per slab, or an origin interval and four) exact: on seeded
    packets (B5's with every 5th ray axis-aligned, so that an inverse
    direction is 1/INV_EPS), every leaf that passes its packet's interval
    test lies in a word whose box passes it too, with an entry no larger
    and an exit no smaller; so the plain words set no bit in a word that
    the pre-test drops. A packet whose inverse-direction bound is not
    finite (the fence) tests every word."""
    sc, cam = scene
    lt = sc.leaves
    (om, oM, idir, mb), tested, words, n_tame = _mode_packets(sc, cam, mode)
    im, iM = zip(*[pt._widen(c.amin(1), c.amax(1)) for c in idir])
    n = lt.n_leaf
    tn, tf = pt._interval_test(lt.box[:, :n], om, oM, im, iM, mb)
    wtn, wtf = pt._interval_test(lt.wbox, om, oM, im, iM, mb)
    tn, tf, wtn, wtf = (x[:n_tame] for x in (tn, tf, wtn, wtf))
    ok = (tn <= tf) & (tf > 0.0)
    assert 100 < int(ok.sum()) < ok.numel()
    of = torch.arange(n) // pt.WARP
    assert bool((wtn[:, of] <= tn)[ok].all())
    assert bool((wtf[:, of] >= tf)[ok].all())
    assert bool(tested[:n_tame, of][ok].all())
    assert not bool(tested[:n_tame].all())
    if mode != "camera":
        assert len(tested) == n_tame + 1 and bool(tested[n_tame:].all())
    assert words.ne(0).any()
    assert not bool((words.ne(0).any(1) & ~tested).any())


def test_b5s_shared_memory_bounds_its_leaf_tables(monkeypatch):
    """Leaf tables hold at most WL_MAX_LP slots, the most the words passes
    take: a scene with more leaves gets node tables when it is built
    (here with the limit lowered below the 3,072 slots of
    terrain_scene(96) at leaf 8), one with as many keeps its leaf tables,
    and both render the forward frame within 2e-3 on all but 0.1 % of the
    pixels (the walk frames' rule)."""
    from snail_tpu_torch.scene import scene as scene_mod

    assert pt.WL_MAX_LP == 419 * pt.LEAF_BLOCK
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    imgs = []
    for limit, leaves in ((3 * pt.LEAF_BLOCK, True),
                          (2 * pt.LEAF_BLOCK, False)):
        with monkeypatch.context() as m:
            m.setattr(scene_mod, "WL_MAX_LP", limit)
            sc, cam = _build("terrain", 96)
        assert (sc.leaves is not None) == leaves
        assert (sc.nodes is None) == leaves
        if leaves:
            assert sc.leaves.lp == limit
        imgs.append(render_frame_fast_stats(sc, cam, 64, 64, fwd)[0])
    err = (imgs[0] - imgs[1]).abs()
    assert float((err > 2e-3).float().mean()) <= 1e-3, float(err.max())
    assert float(imgs[0].max()) > 0.1
