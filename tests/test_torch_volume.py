"""The port's volume subsystem against the JAX package's
(``snail_tpu.volume``): DICOM files written by each package read back
equal by the other, ``load_raw`` and ``synthetic_sphere`` equal, the
min/max pyramid bit for bit, the plain march ``_march_plain`` against JAX
``_march`` on the same rays (a sphere and a volume with a non-zero
border, iso and mip), the mip mode's extra sample of a ray done early
(ROADMAP C19) in both, ``render_volume`` against the JAX package's, and
the viewer writing a PNG from a raw file and from a DICOM directory.

Tolerances: XLA's CPU compiler fuses the JAX loop body and may contract a
product and a sum into one rounding where the port rounds twice, so a
ray's position can differ in its last bit; the march then agrees in every
hit/miss decision, ``hit_t`` to rtol 1e-6 and ``best`` to atol 1e-6
(measured: 2.7e-7 and 5.4e-7). A march cut off by a small ``max_steps``
is not compared across the packages: an ulp can flip a skip into a fine
step, and the cut then falls elsewhere (the card tests hold the kernel
to the plain version bit for bit there). Images: the two packages'
cameras normalise their rays with different rsqrts (ROADMAP C), so a
silhouette pixel may flip: atol 2e-3 on >= 99.8 % of pixels, as every
frame's parity test (measured: every pixel within 1.1e-5)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snail_tpu.core.types import Camera as JCamera
from snail_tpu.volume import data as jdata
from snail_tpu.volume import vtree as jv

from snail_tpu_torch.apps import dicom_viewer
from snail_tpu_torch.core.types import Camera
from snail_tpu_torch.ops import march as pm
from snail_tpu_torch.volume import data as pdata
from snail_tpu_torch.volume import vtree as pv

N = 64
ISO = 0.03
BORDER = 1500  # u16 value of the border shell: below ISO, seen by mip


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain march is hundreds of lockstep steps of small tensor ops.
    On a machine whose cores other test workers keep busy, PyTorch's
    intra-op thread pool makes each of them wait (a march took 44 s there
    against 0.7 s on one thread), so they run on one thread; the result
    does not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volumes():
    """(name, u16 data): the 64^3 sphere, and the sphere with a constant
    one-voxel shell on all six faces."""
    sphere = pdata.synthetic_sphere(N).data
    border = sphere.copy()
    for a in range(3):
        idx = [slice(None)] * 3
        idx[a] = [0, -1]
        border[tuple(idx)] = BORDER
    return [("sphere", sphere), ("border", border)]


VOLUMES = _volumes()
CAMS = [(N * 0.5, N * 0.5, -1.5 * N), (N * 1.5, N * 1.1, N * 1.3)]


@pytest.fixture(scope="module")
def trees():
    return {name: (jv.build_vtree(jdata.VolumeData(data=a)),
                   pv.build_vtree(pdata.VolumeData(data=a), device="cpu"))
            for name, a in VOLUMES}


def test_synthetic_sphere_and_load_raw_equal(tmp_path):
    for n, r, v in ((32, 0.35, 4000), (48, 0.2, 1234)):
        a = jdata.synthetic_sphere(n, r, v)
        b = pdata.synthetic_sphere(n, r, v)
        assert b.data.dtype == np.uint16 and b.spacing == a.spacing
        np.testing.assert_array_equal(a.data, b.data)
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 65535, (6, 10, 8)).astype(np.uint16)
    path = str(tmp_path / "v.raw")
    raw.tofile(path)
    a, b = jdata.load_raw(path, (6, 10, 8)), pdata.load_raw(path, (6, 10, 8))
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(b.data, raw)


@pytest.mark.parametrize("writer,reader", [(jdata, pdata), (pdata, jdata)],
                         ids=["jax_writes", "port_writes"])
def test_dicom_read_by_the_other_package(tmp_path, writer, reader):
    rng = np.random.default_rng(7)
    slices = [rng.integers(0, 4000, (12, 9)).astype(np.uint16)
              for _ in range(5)]
    for i in (3, 0, 4, 1, 2):  # written out of order: sorted by location
        writer.write_dicom_file(str(tmp_path / f"s{i:02d}.dcm"), slices[i],
                                slice_location=-4.0 + 1.5 * i,
                                pixel_spacing=(0.7, 0.8))
    (tmp_path / "notes.txt").write_text("not a slice")
    pix, meta = reader.load_dicom_file(str(tmp_path / "s01.dcm"))
    np.testing.assert_array_equal(pix, slices[1])
    assert meta == {"pixel_spacing": (0.7, 0.8), "slice_location": -2.5}
    vd = reader.load_dicom_dir(str(tmp_path))
    np.testing.assert_array_equal(vd.data, np.stack(slices))
    assert vd.spacing == pytest.approx((1.5, 0.7, 0.8))
    # the same bytes from both writers
    other = tmp_path / "other.bin"
    reader.write_dicom_file(str(other), slices[0], slice_location=-4.0,
                            pixel_spacing=(0.7, 0.8))
    assert other.read_bytes() == (tmp_path / "s00.dcm").read_bytes()


def test_pyramid_bit_equal(trees):
    for name, (jt, ptr) in trees.items():
        assert ptr.shape == jt.shape == (N, N, N)
        for k in ("vol", "brick_max", "brick_min", "coarse_max"):
            a, b = np.asarray(getattr(jt, k)), getattr(ptr, k).numpy()
            assert b.dtype == a.dtype == np.float32, k
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {k}")
    # a shape that is not a multiple of the brick pads as the JAX build
    vd = jdata.VolumeData(data=np.random.default_rng(1).integers(
        0, 9000, (10, 21, 6)).astype(np.uint16))
    a = jv.build_vtree(vd)
    b = pv.build_vtree(pdata.VolumeData(data=vd.data), device="cpu")
    for k in ("brick_max", "brick_min", "coarse_max"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)))


def _rays(ptr, pos, w=96, h=96):
    cam = Camera.look_at(pos=pos, target=(N * 0.5,) * 3, device="cpu")
    return pv.volume_rays(ptr, cam, w, h)


def _jax_march(jt, rays, mode, max_steps):
    o, d, t0, t1 = (jnp.asarray(x.numpy()) for x in rays)
    best, hit_t = jv._march(jt.vol, jt.brick_max, jt.brick_min,
                            jt.coarse_max, o, d, t0, t1, ISO, jt.shape,
                            mode, max_steps)
    return np.asarray(best), np.asarray(hit_t)


@pytest.mark.parametrize("mode", ["iso", "mip"])
@pytest.mark.parametrize("name", [v[0] for v in VOLUMES])
def test_march_plain_matches_jax(trees, name, mode):
    jt, ptr = trees[name]
    for pos in CAMS:
        rays = _rays(ptr, pos)
        pb, ph = (x.numpy() for x in pv._march_plain(ptr, *rays, ISO, mode,
                                                     2048))
        jb, jh = _jax_march(jt, rays, mode, 2048)
        np.testing.assert_array_equal(ph >= 0, jh >= 0)
        np.testing.assert_allclose(ph, jh, rtol=1e-6, atol=0)
        np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)
        if mode == "iso":
            assert 0.05 < (ph >= 0).mean() < 0.5 and (pb == 0).all()
        else:
            assert (ph == -1).all() and pb.max() == pytest.approx(
                4000 / 65535, rel=1e-6)
    # the wrapper takes the plain version for tensors on the CPU
    best, hit_t = pm.march(ptr, *rays, ISO, mode, 2048)
    np.testing.assert_array_equal(best.numpy(), pb)
    np.testing.assert_array_equal(hit_t.numpy(), ph)


def test_mip_extra_sample_of_done_rays(trees):
    """C19: in the JAX loop a mip ray that is done keeps sampling at its
    frozen t while others march, so a ray that misses the volume (t0 > t1,
    frozen at max(t0, 0)) takes the clamped border voxels' value: 0 on the
    sphere, the shell's value on the border volume. Both packages do it."""
    for name, value in (("sphere", 0.0), ("border", BORDER / 65535)):
        jt, ptr = trees[name]
        rays = _rays(ptr, CAMS[0])
        miss = (rays[2] > rays[3]).numpy()
        assert 0.3 < miss.mean() < 0.95
        pb = pv._march_plain(ptr, *rays, ISO, "mip", 2048)[0].numpy()
        jb, _ = _jax_march(jt, rays, "mip", 2048)
        np.testing.assert_allclose(pb[miss], value, rtol=1e-6, atol=0)
        np.testing.assert_allclose(jb[miss], value, rtol=1e-6, atol=0)
        # with every ray done at the start, no step at all
        none = tuple(x[miss] for x in rays)
        assert (pv._march_plain(ptr, *none, ISO, "mip", 2048)[0] == 0).all()


def _smoke():
    """chip_smoke.py as a module (it imports nothing of its own at the
    top, and runs nothing on import)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_march_plain_tally(trees):
    """The tally the smoke's bound reads (``chip_smoke.march_tally``), from
    the steps of the plain loop (``_march_step``, which ``_march_plain``
    loops): every live step, samples among them, bricks read; in mip mode
    one extra step per ray done early. Looping the step reproduces
    ``_march_plain``."""
    march_tally = _smoke().march_tally
    _, ptr = trees["border"]
    rays = _rays(ptr, CAMS[1], 32, 32)
    live0 = int((rays[2] <= rays[3]).sum())
    for mode in ("iso", "mip"):
        steps, samples, bricks = march_tally(ptr, rays, ISO, mode, 2048)
        assert live0 <= steps and 0 < samples <= steps
        assert 0 < bricks < ptr.brick_max.numel()
        state = pv._march_start(*rays[2:])
        for _ in range(3):
            state, _, _ = pv._march_step(ptr, *rays[:2], rays[3], ISO, mode,
                                         state)
        for a, b in zip(state[2:], pv._march_plain(ptr, *rays, ISO, mode, 3)):
            assert torch.equal(a, b)
    steps, _, _ = march_tally(ptr, rays, ISO, "mip", 1)
    assert steps == rays[2].shape[0]  # one step each, none extra


@pytest.mark.parametrize("mode", ["iso", "mip"])
def test_render_volume_matches_jax(trees, mode):
    jt, ptr = trees["sphere"]
    for pos in CAMS:
        jcam = JCamera.look_at(pos=pos, target=(N * 0.5,) * 3)
        cam = Camera.look_at(pos=pos, target=(N * 0.5,) * 3, device="cpu")
        j = np.asarray(jv.render_volume(jt, jcam, 96, 96, iso=ISO,
                                        mode=mode))
        p = pv.render_volume(ptr, cam, 96, 96, iso=ISO, mode=mode).numpy()
        assert p.shape == (96, 96, 3) and p.dtype == np.float32
        err = np.abs(p - j).max(-1)
        assert (err > 2e-3).mean() <= 0.002, (pos, (err > 2e-3).mean())
        assert j.max() > 0.5


def test_dicom_viewer_writes_png(tmp_path, capsys):
    from PIL import Image

    vol = pdata.synthetic_sphere(32).data
    raw = tmp_path / "sphere.raw"
    vol.tofile(str(raw))
    out = tmp_path / "raw.png"
    dicom_viewer.main([str(raw), "--raw-shape", "32,32,32", "--res",
                       "48x32", "--out", str(out), "--device", "cpu"])
    a = np.asarray(Image.open(out))
    assert a.shape == (32, 48, 3) and a.max() > 100 and a[0, 0].max() == 0
    d = tmp_path / "series"
    d.mkdir()
    for i, s in enumerate(vol):
        pdata.write_dicom_file(str(d / f"{i:03d}.dcm"), s,
                               slice_location=float(i))
    out2 = tmp_path / "dicom.png"
    dicom_viewer.main([str(d), "--res", "48x32", "--mode", "iso", "--out",
                       str(out2), "--device", "cpu"])
    np.testing.assert_array_equal(np.asarray(Image.open(out2)), a)
    out3 = tmp_path / "mip.png"
    dicom_viewer.main([str(d), "--res", "48x32", "--mode", "mip", "--out",
                       str(out3), "--device", "cpu"])
    assert np.asarray(Image.open(out3)).max() == 255
    assert "wrote" in capsys.readouterr().out
    assert os.path.exists(out3)


def test_corners_index_past_2_31_voxels():
    """ROADMAP C20: the trilinear taps' flat indices of a (4096, 1024,
    1024) volume (2^32 voxels) are exact: each tap the per-axis clamped
    voxel of the JAX package's indexing (``snail_tpu/volume/vtree.py``
    ``_sample``), flattened in int64, as V1 does in size_t. No volume is
    allocated."""
    shape = (4096, 1024, 1024)
    pts = np.array([[4000.2, 1000.3, 1000.7], [4095.9, 1023.9, 1023.6],
                    [2048.5, 512.5, 0.2], [0.1, 0.3, 1023.99]], np.float32)
    idx, f = pv._corners(torch.from_numpy(pts), shape)
    assert idx.dtype == torch.int64 and idx.shape == (4, 2, 2, 2)
    q = pts.astype(np.float32) - np.float32(0.5)
    q0 = np.floor(q).astype(np.int64)
    top = np.array(shape, np.int64) - 1
    taps = np.clip(np.stack([q0, q0 + 1], -1), 0, top[:, None])  # (R, 3, 2)
    z, y, x = taps[:, 0], taps[:, 1], taps[:, 2]
    want = ((z[:, :, None, None] * shape[1] + y[:, None, :, None])
            * shape[2] + x[:, None, None, :])
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(f.numpy(), q - np.floor(q))
    assert want[0, 1, 1, 1] == (4000 * 1024 + 1000) * 1024 + 1001 > 2 ** 31
