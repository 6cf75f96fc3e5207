"""The port's host loaders against the JAX package's, on files written
into ``tmp_path``: OBJ, MTL, the material table, PNG textures, Doom 3
``.proc``/``materials.mtr``/``.list``, Desperados 2 ``.v3o`` with its
heightmap, the geometry cache and the BVH cache (each package reading the
other's files), every array equal; then ``load_scene`` of an OBJ + MTL +
PNGs with ``map_Kd`` and ``map_d`` rendered by the forward (64 x 64) and
portable (64 x 48) frames with each filter, and ROADMAP item 7's four
lights with 2 x 2 supersampling, against the JAX package's frames (Pallas
in interpret mode, run eagerly as in tests/test_torch_textures.py; the
portable frame through its jnp reference traversal). Images: atol 2e-3 on
>= 99.8 % of pixels."""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

import jax

from snail_tpu.bvh import cache as jcache
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.render import fast as jfast
from snail_tpu.render.renderer import render_frame as j_render_frame
from snail_tpu.scene import desperados2 as jd2
from snail_tpu.scene import doom3 as jd3
from snail_tpu.scene import materials as jmat
from snail_tpu.scene import scene as jscene
from snail_tpu.scene import textures as jtex
from snail_tpu.scene import wavefront as jwf

from snail_tpu_torch.bvh import cache as pcache
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import desperados2 as pd2
from snail_tpu_torch.scene import doom3 as pd3
from snail_tpu_torch.scene import materials as pmat
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene import scene as pscene
from snail_tpu_torch.scene import textures as ptex
from snail_tpu_torch.scene import wavefront as pwf

W = H = 64
PORTABLE = (64, 48)


def _same_base(a, b):
    """Two BaseScenes (either package's) hold the same objects, material
    registry and mtl libraries."""
    assert a.mat_names == b.mat_names and a.mtl_libs == b.mtl_libs
    assert len(a.objects) == len(b.objects)
    for oa, ob in zip(a.objects, b.objects):
        assert oa.name == ob.name
        for f in dataclasses.fields(oa):
            x, y = getattr(oa, f.name), getattr(ob, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)


def _same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


# --- OBJ, MTL, the material table, PNG textures ---

MTL = """# three materials and one the OBJ does not use
newmtl plain
Kd 0.8 0.7 0.6
Ks 0.3
d 0.5
newmtl checker  # a comment after a name
Kd 1 1 1
Ns 32
map_Kd -bm 0.5 checker.png
newmtl glass
Ka 0.1 0.1 0.1
Kd 0.4 0.6 0.9
Tf 0.5 0.5 0.5
illum 4
d -halo 0.5
Ni 1.5
map_Kd checker.png
map_d alpha.png
newmtl unused
Ke 2
map_Ks spec.png
"""


def _write_obj(path, mtllib="scene.mtl"):
    """city_scene(12)'s buildings and ground (1,358 triangles) as OBJ
    with planar ``vt`` (1/4 of x and z), the faces wound so that
    load_scene's flip gives the procedural winding, every 12 faces (a
    box) in the next of three ``usemtl`` groups; then a floor quad under
    it, in relative indices with normals, a pentagon fan and a degenerate
    face (dropped by the parser's repair)."""
    (obj,) = pproc.city_scene(12).objects
    groups = ("plain", "checker", "glass")
    lines = [f"mtllib {mtllib}", "o city"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in obj.verts]
    lines += [f"vt {x / 4:.6f} {z / 4:.6f}" for x, _, z in obj.verts]
    for i, (a, b, c) in enumerate(obj.tri_v + 1):
        if i % 12 == 0:
            lines.append(f"usemtl {groups[i // 12 % 3]}")
        lines.append(f"f {b}/{b} {a}/{a} {c}/{c}")
    lines += ["v -14 -0.5 -14", "v 14 -0.5 -14", "v 14 -0.5 14",
              "v -14 -0.5 14",
              "vt 0 0", "vt 3 0", "vt 3 3", "vt 0 3", "vn 0 1 0",
              "usemtl checker",
              "f -1/-1/-1 -2/-2/-1 -3/-3/-1 -4/-4/-1",
              "v 0 -0.4 0", "v 1 -0.4 0", "v 1.5 -0.4 1", "v 0.5 -0.4 2",
              "v -0.5 -0.4 1",
              "f -1 -2 -3 -4 -5",
              "f 1 1 2"]
    path.write_text("\n".join(lines) + "\n")


def _write_pngs(d):
    """checker.png 48 x 40 (not a power of two: resized to 64 x 64 at
    load) and alpha.png, a 16 x 16 ramp for the dissolve map."""
    from PIL import Image

    yy, xx = np.mgrid[0:40, 0:48]
    chk = ((yy // 5 + xx // 6) % 2)[..., None] * np.array([200, 120, 40])
    Image.fromarray((chk + 30).astype(np.uint8)).save(d / "checker.png")
    ramp = np.repeat(np.linspace(40, 250, 16)[None, :], 16, 0)
    Image.fromarray(np.stack([ramp] * 3, -1).astype(np.uint8)).save(
        d / "alpha.png")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    _write_obj(d / "scene.obj")
    (d / "scene.mtl").write_text(MTL)
    _write_pngs(d)
    return d


@pytest.mark.parametrize("repair", [True, False])
def test_wavefront_obj_equal(files, repair):
    j = jwf.load_wavefront_obj(str(files / "scene.obj"), repair=repair)
    p = pwf.load_wavefront_obj(str(files / "scene.obj"), repair=repair)
    _same_base(j, p)
    assert p.mtl_libs == ["scene.mtl"]
    assert list(p.mat_names) == ["", "plain", "checker", "glass"]
    _same_fields(j.flatten(), p.flatten())


def test_material_descs_and_table_equal(files):
    j = jmat.load_material_descs(str(files / "scene.mtl"))
    p = pmat.load_material_descs(str(files / "scene.mtl"))
    assert [d.name for d in p] == ["plain", "checker", "glass", "unused"]
    for a, b in zip(j, p):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    names = {"": 0, "plain": 1, "checker": 2, "glass": 3, "missing": 4}
    tex = {"checker.png": 0, "alpha.png": 1}
    refl = {"plain": 0.25, "missing": 0.5}
    _same_fields(jmat.MaterialTable.build(names, j, tex, refl),
                 pmat.MaterialTable.build(names, p, tex, refl))
    assert pmat.F_TEXCOORDS == 1 and pmat.F_TRANSPARENCY == 8
    # the one-argument build keeps giving the default table
    _same_fields(jmat.MaterialTable.build(names, []),
                 pmat.MaterialTable.build(names))
    assert pmat.load_material_descs(str(files / "absent.mtl")) == []


def test_texture_atlas_equal(files):
    descs = pmat.load_material_descs(str(files / "scene.mtl"))
    (ja, jm), jids = jtex.load_texture_atlas(
        jmat.load_material_descs(str(files / "scene.mtl")), str(files))
    (pa, pm), pids = ptex.load_texture_atlas(descs, str(files))
    assert pids == jids == {"checker.png": 0, "alpha.png": 1}
    np.testing.assert_array_equal(pa, np.asarray(ja))
    np.testing.assert_array_equal(pm, np.asarray(jm))
    assert pa.shape == (2, 128, 64, 3)  # 48 x 40 resized to 64 x 64
    assert ptex.load_texture_atlas(descs, str(files / "none")) == (None, {})


# --- Doom 3 and Desperados 2 ---

MTR = """
table fancyTable { { 0, 1, 0.5 } }
textures/base_wall/lfwall1
{
    qer_editorimage textures/base_wall/lfwall1.tga
    diffusemap map textures/base_wall/lfwall1_d
    bumpmap textures/base_wall/lfwall1_local.tga
}
textures/rock/sharprock
{
    diffusemap textures/rock/sharprock.tga
}
"""

PROC = """
mapProcFile003
// a comment
model { "_area0" 2
/* surface 0 */ { "textures/base_wall/lfwall1" 4 6
( 0 0 0 0 0 0 1 0 ) ( 1 0 0 1 0 0 1 0 )
( 1 0 1 1 1 0 1 0 ) ( 0 0 1 0 1 0 1 0 )
0 1 2 0 2 3
}
/* surface 1 */ { "textures/decals/splat" 3 3
( 0 5 0 0 0 0 1 0 ) ( 1 5 0 1 0 0 1 0 ) ( 1 5 1 1 1 0 1 0 )
0 1 2
}
}
model { "_area1" 1
{ "textures/rock/sharprock" 3 3
( 2 0 0 0 0 0 1 0 ) ( 3 0 0 1 0 0 1 0 ) ( 3 0 1 1 1 0 1 0 )
0 1 2
}
}
interAreaPortals { 0 0 }
"""

V3O = """// comment line
D 1000, 2000, 3000, 0 0 0 0 0 0 0 0 0
D 2000, 2000, 3000, 0 0 0 0 0 0 0 0 0
D 1000, 3000, 3000, 0 0 0 0 0 0 0 0 0
D 1000, 2000, 4000, 0 0 0 0 0 0 0 0 0
SRF wall _ _ _ brick.tga _ _ _ _ _ 0
SRF fence _ _ _ wire.tga _ _ _ _ _ 1
P 3 1 2 3 0 0 0 0 1
P 3 1 2 4 0 0 0 0 2
P 4 1 2 3 4 0 0 0 1
TLS 3 2 3 4
HMAP map.raw
HF 1 2 3 4 32767 0 0 0 0 0 0 1 1
P 3 1 2 3 0 0 0 0 0
"""


@pytest.fixture(scope="module")
def level(tmp_path_factory, files):
    d = tmp_path_factory.mktemp("level")
    (d / "materials.mtr").write_text(MTR)
    (d / "level.proc").write_text(PROC)
    (d / "map.raw").write_bytes(struct.pack("<HH", 2, 2) + b"\0" * 15
                                + struct.pack("<4H", 100, 200, 300, 400))
    (d / "level.v3o").write_text(V3O)
    for name in ("a.obj", "b.obj"):
        (d / name).write_bytes((files / "scene.obj").read_bytes())
    (d / "both.list").write_text("a.obj\n\nb.obj\n")
    return d


def test_doom3_loaders_equal(level):
    mtr = str(level / "materials.mtr")
    assert pd3.load_mat2texture_map(mtr) == jd3.load_mat2texture_map(mtr)
    j = jd3.load_doom3_proc(str(level / "level.proc"))
    p = pd3.load_doom3_proc(str(level / "level.proc"))
    _same_base(j, p)
    assert [o.num_tris for o in p.objects] == [2, 1]  # the decal dropped
    _same_fields(j.flatten(), p.flatten())
    j = jd3.load_list(str(level / "both.list"))
    p = pd3.load_list(str(level / "both.list"))
    _same_base(j, p)
    _same_base(jd3.load_list(str(level / "both.list"), max_total_tris=10),
               pd3.load_list(str(level / "both.list"), max_total_tris=10))


def test_desperados2_loader_equal(level):
    for scale in (1.0, 2.5):
        j = jd2.load_v3o(str(level / "level.v3o"), scale=scale)
        p = pd2.load_v3o(str(level / "level.v3o"), scale=scale)
        _same_base(j, p)
        _same_fields(j.flatten(), p.flatten())
    assert p.num_tris == 7  # 4 + the heightfield quad's 2 + the last P


@pytest.mark.parametrize("name", ["level.proc", "both.list", "a.obj",
                                  "level.v3o"])
def test_load_any_dispatch_equal(level, name):
    _same_base(jd3.load_any(str(level / name)),
               pd3.load_any(str(level / name)))


def test_load_any_rejects_unknown():
    with pytest.raises(ValueError, match="Unrecognized"):
        pd3.load_any("scene.bin")


# --- the geometry and BVH caches, across the packages ---

def test_geometry_cache_read_by_the_other_package(files, tmp_path):
    obj = str(files / "scene.obj")
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jg, jb = jscene._load_geom_cached(obj, jdir, True, True)
    pg, pb = pscene._load_geom_cached(obj, pdir, True, True)
    _same_fields(jg, pg)
    assert jb.mat_names == pb.mat_names and jb.mtl_libs == pb.mtl_libs
    # each reads the other's file: a cache hit, no parse
    pg2, pb2 = pscene._load_geom_cached(obj, jdir, True, True)
    jg2, jb2 = jscene._load_geom_cached(obj, pdir, True, True)
    assert isinstance(pb2, pscene._CachedBaseMeta)
    assert isinstance(jb2, jscene._CachedBaseMeta)
    _same_fields(pg, pg2)
    _same_fields(jg, jg2)
    assert pb2.mat_names == pb.mat_names and pb2.mtl_libs == pb.mtl_libs
    # another key (no flip) misses the cache
    pg3, pb3 = pscene._load_geom_cached(obj, jdir, False, True)
    assert not isinstance(pb3, pscene._CachedBaseMeta)


def test_bvh_cache_read_by_the_other_package(files, tmp_path):
    g = pwf.load_wavefront_obj(str(files / "scene.obj")).flatten()
    lo, hi = g.bounds()
    assert pcache._content_key(lo, hi, 8, "binned") == jcache._content_key(
        lo, hi, 8, "binned")
    jb = jcache.build_or_load(lo, hi, str(tmp_path / "j"), "s", 8)
    pb = pcache.build_or_load(lo, hi, str(tmp_path / "p"), "s", 8)
    _same_fields(jb, pb)
    key = pcache._content_key(lo, hi, 8, "binned")
    _same_fields(pcache.load_bvh(str(tmp_path / "j" / "s.bvh.npz"), key), jb)
    _same_fields(jcache.load_bvh(str(tmp_path / "p" / "s.bvh.npz"), key), pb)
    # a stale key or a missing file reads nothing
    assert pcache.load_bvh(str(tmp_path / "j" / "s.bvh.npz"), "x") is None
    assert pcache.load_bvh(str(tmp_path / "none.npz")) is None


# --- load_scene and its frames ---

_COND = jax.lax.cond


def _eager_cond(pred, true_fn, false_fn, *operands, **kw):
    """``lax.cond`` outside ``jit`` with a concrete predicate runs one
    branch, as this does, without compiling both (traced conds stay)."""
    if isinstance(pred, jax.core.Tracer):
        return _COND(pred, true_fn, false_fn, *operands, **kw)
    return (true_fn if bool(pred) else false_fn)(*operands, **kw)


@pytest.fixture(autouse=True)
def eager_cond(monkeypatch):
    monkeypatch.setattr(jax.lax, "cond", _eager_cond)


def _close(name, p, j):
    j = np.asarray(j)
    err = np.abs(p.numpy() - j).max(-1)
    assert p.shape == j.shape, name
    assert (err > 2e-3).mean() <= 2e-3, (name, (err > 2e-3).mean(),
                                         err.max())
    assert j.max() > 0.1, name


def _cams(p):
    """Both packages' camera on the loaded scene, from the front, above."""
    lo, hi = p.root_lo.numpy(), p.root_hi.numpy()
    c = (lo + hi) * 0.5
    pos = tuple(c + np.array([0.45, 0.55, 0.9]) * float((hi - lo).max()))
    return (JCamera.look_at(pos=pos, target=tuple(c)),
            Camera.look_at(pos=pos, target=tuple(c), device="cpu"))


@pytest.fixture(scope="module")
def loaded(files, tmp_path_factory):
    """load_scene of scene.obj in both packages (MTL found by mtllib,
    textures from the directory), with the SATs."""
    cache = tmp_path_factory.mktemp("dump")
    obj = str(files / "scene.obj")
    j = jscene.with_sat(jscene.load_scene(obj, tex_dir=str(files),
                                          cache_dir=str(cache / "j")))
    p = pscene.with_sat(pscene.load_scene(obj, tex_dir=str(files),
                                          cache_dir=str(cache / "p"),
                                          device="cpu"))
    return j, p


def test_load_scene_arrays_match_jax(loaded):
    j, p = loaded
    for name in ("sh_pack", "mat_pack", "tri_a", "tri_ba", "tri_ca",
                 "sh_mat", "mat_diffuse", "mat_specular", "tex_atlas",
                 "tex_meta", "tex_sat"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("pos", "color", "radius"):
        np.testing.assert_array_equal(getattr(p.lights, name).numpy(),
                                      np.asarray(getattr(j.lights, name)))
    assert (p.has_refl, p.has_transp, p.has_diss_tex) == (False, True, True)
    # glass reads alpha.png as its dissolve map, the others no map
    assert p.mat_pack[:, 9].tolist() == [-1, -1, -1, 1]


@pytest.mark.parametrize("filt", ["point", "bilinear", "sat"])
def test_loaded_fwd_frame_matches_jax(loaded, filt):
    """The packed frame with transparency (the plain material's d 0.5)
    and each filter; like the JAX package's, it reads no dissolve map."""
    j, p = loaded
    jcam, pcam = _cams(p)
    opts = dict(reflections=False, textures=True, tex_filter=filt)
    _close(filt, render_frame(p, pcam, W, H, RenderOpts(**opts)),
           jfast.render_frame_fast.__wrapped__(j, jcam, W, H,
                                               JRenderOpts(**opts)))


@pytest.mark.parametrize("filt", ["point", "bilinear", "sat"])
def test_loaded_portable_frame_matches_jax(loaded, filt):
    """The portable integrator at 64 x 48, transparency on: the glass
    material's opacity comes from its dissolve map."""
    j, p = loaded
    jcam, pcam = _cams(p)
    opts = dict(reflections=False, textures=True, tex_filter=filt)
    img = render_frame(p, pcam, *PORTABLE, RenderOpts(**opts))
    _close(filt, img, j_render_frame(j.with_backend("reference"), jcam,
                                     *PORTABLE, JRenderOpts(**opts)))
    if filt == "point":  # the map is read: without it the frame changes
        mp = p.mat_pack.clone()
        mp[:, 9] = -1.0
        plain = render_frame(dataclasses.replace(p, mat_pack=mp), pcam,
                             *PORTABLE, RenderOpts(**opts))
        assert float((plain - img).abs().max()) > 1e-2


# bench.py:325-330's four lights (colour 0.8, radius 60) at 1.5 times its
# positions and radius, for city_scene(12)'s 24-unit extent about the origin
FOUR = (np.array([[8.0, 12.0, 8.0], [-8.0, 12.0, 8.0], [8.0, 12.0, -8.0],
                  [-8.0, 12.0, -8.0]], np.float32) * 1.5,
        np.full((4, 3), 0.8, np.float32), np.full((4,), 90.0, np.float32))


def test_four_lights_supersampled_matches_jax(loaded):
    """ROADMAP item 7: the loaded scene under bench.py's four lights with
    2 x 2 supersampling (the 128 x 128 frame box-averaged)."""
    j, p = loaded
    j = dataclasses.replace(j, lights=JLight.make(*FOUR))
    p = dataclasses.replace(p, lights=Light.make(*FOUR, device="cpu"))
    jcam, pcam = _cams(p)
    opts = dict(reflections=False, transparency=False, textures=True,
                supersample=True, tex_filter="bilinear")
    big = jfast.render_frame_fast.__wrapped__(j, jcam, 2 * W, 2 * H,
                                              JRenderOpts(**opts))
    jimg = (big[0::2, 0::2] + big[1::2, 0::2] + big[0::2, 1::2]
            + big[1::2, 1::2]) * 0.25  # the JAX renderer.py:46-50
    img = render_frame(p, pcam, W, H, RenderOpts(**opts))
    assert img.shape == (H, W, 3)
    _close("4 lights", img, jimg)
    one = render_frame(dataclasses.replace(p, lights=Light.make(
        *(x[:1] for x in FOUR), device="cpu")), pcam, W, H,
        RenderOpts(**opts))
    assert float(img.mean()) > float(one.mean())


def test_load_scene_reads_its_cache(files, tmp_path):
    """A second load_scene from the same cache directory gives the same
    scene, read from the cache files the first one wrote."""
    obj = str(files / "scene.obj")
    a = pscene.load_scene(obj, tex_dir=str(files), cache_dir=str(tmp_path),
                          device="cpu", walk=True)
    assert sorted(os.listdir(tmp_path)) == ["scene.bvh.npz", "scene.geom.npz"]
    b = pscene.load_scene(obj, tex_dir=str(files), cache_dir=str(tmp_path),
                          device="cpu", walk=True)
    assert a.leaves is None and b.nodes is not None
    for name in ("tri_rows", "sh_pack", "mat_pack", "tex_atlas"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.nodes.node, b.nodes.node)


def test_image_utils_and_frame_counter_match_jax(tmp_path):
    """utils.image: a frame saved by the port reads back the same in both
    packages, and compare_img gives the JAX package's numbers;
    utils.frame_counter counts frames as the JAX package's does."""
    from snail_tpu.utils import frame_counter as jfc
    from snail_tpu.utils import image as jimg

    from snail_tpu_torch.utils import frame_counter as pfc
    from snail_tpu_torch.utils import image as pimg

    rng = np.random.default_rng(8)
    a = rng.random((12, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1).astype(np.float32)
    pimg.save_image(str(tmp_path / "p.png"), torch.from_numpy(a).numpy())
    jimg.save_image(str(tmp_path / "j.png"), a)
    for name in ("p.png", "j.png"):
        got = pimg.load_image(str(tmp_path / name))
        np.testing.assert_array_equal(got, jimg.load_image(
            str(tmp_path / name)))
        assert got.shape == a.shape and np.abs(got - a).max() <= 1 / 255
    assert pimg.compare_img(a, b) == jimg.compare_img(a, b)
    counters = [pfc.FrameCounter(), jfc.FrameCounter()]
    for _ in range(3):
        for c in counters:
            c.tick()
    assert [c._frames for c in counters] == [3, 3]
    assert all(c.fps > 0 and c.fps_min <= c.fps_max for c in counters)
    counters[0].reset()
    assert counters[0].fps == 0.0 and counters[0].fps_avg == 0.0
