"""The port's apps (``snail_tpu_torch.apps``) on the CPU: the render
server's session over a socketpair (handshake, two frames, a stats frame)
with each assembled frame equal to the port's ``render_frame`` bit for bit
and, after rgb8, to the JAX package's frame within 1 level on >= 99.8 % of
pixels (their cameras' rsqrts differ, ROADMAP C; Pallas in interpret
mode, run eagerly as in tests/test_torch_textures.py), the stats message
equal to the counter frame's counters; a scene name outside the scene
directory refused; an encoder that fails or stalls ending the session
with an error within its timeout (ROADMAP C6); the client against
``server.main`` on 127.0.0.1; ``rtracer`` writing the frames
``Renderer`` renders. The scene is city_scene(4) written as an OBJ + MTL
into ``tmp_path`` (``chip_smoke.write_city_obj``)."""

import importlib.util
import os
import socket
import threading
import time

import numpy as np
import pytest

from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.render import fast as jfast
from snail_tpu.scene import scene as jscene

from snail_tpu_torch.apps import client, rtracer, server
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.net import protocol
from snail_tpu_torch.render.fast import render_frame_fast_stats
from snail_tpu_torch.render.renderer import Renderer, render_frame, to_rgb8
from snail_tpu_torch.scene.scene import load_scene
from snail_tpu_torch.utils.stats import tree_stats_from_counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
LIGHT = {"pos": [0.0, 15.0, 0.0], "color": [1.0, 1.0, 1.0], "radius": 60.0}
GVALS = {"reflections": False, "transparency": False, "textures": False}
OPTS = dict(reflections=False, transparency=False, textures=False)
CAMS = [((6.0, 7.0, 9.0), (0.0, 1.0, 0.0)), ((-7.0, 5.0, 6.0), (0.5, 0.0, 0.0))]
TIMEOUT = 120  # seconds any one wait of a test may take


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    _smoke().write_city_obj(str(d), 4)
    return str(d)


def _port_scene(scene_dir):
    return load_scene(os.path.join(scene_dir, "city.obj"), device="cpu",
                      lights=Light.make(LIGHT["pos"], LIGHT["color"],
                                        LIGHT["radius"], device="cpu"))


def _reference(scene, pos, target, opts):
    cam = Camera.look_at(pos=pos, target=target, device="cpu")
    return to_rgb8(render_frame(scene, cam, W, H, opts))


class _Session:
    """A server session over a socketpair, serve_connection in a thread;
    ``error`` holds what it raised."""

    def __init__(self, scene_dir, **kw):
        self.srv, self.cli = socket.socketpair()
        self.cli.settimeout(TIMEOUT)
        self.error = None

        def run():
            try:
                server.serve_connection(self.srv, scene_dir, device="cpu",
                                        **kw)
            except Exception as e:
                self.error = e
            finally:
                self.srv.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def frame(self, pos, target, gvals):
        req = protocol.FrameRequest(cam_pos=pos, cam_target=target,
                                    lights=[LIGHT], gvals=gvals)
        protocol.send_json(self.cli, req.to_json())
        parts = list(protocol.recv_parts(self.cli))
        return protocol.assemble(parts, H, W), protocol.recv_json(self.cli)

    def end(self, finish=True):
        if finish:
            protocol.send_json(self.cli, {"type": "finish", "finish": True})
        self.thread.join(TIMEOUT)
        self.cli.close()
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def served(scene_dir):
    """Two frames, then one with the stats toggle: [(image, stats)]."""
    s = _Session(scene_dir)
    protocol.send_json(s.cli,
                       protocol.LoadModel("city.obj", W, H).to_json())
    ready = protocol.recv_json(s.cli)
    out = [s.frame(*CAMS[0], GVALS), s.frame(*CAMS[1], GVALS),
           s.frame(*CAMS[0], {**GVALS, "2": True})]
    s.end()
    assert s.error is None, s.error
    return ready, out


def test_served_frames_equal_render_frame(scene_dir, served):
    ready, frames = served
    scene = _port_scene(scene_dir)
    assert ready["type"] == "model_ready"
    assert ready["num_tris"] == scene.num_tris > 100
    for (img, st), cam in zip(frames, CAMS + CAMS[:1]):
        ref = _reference(scene, *cam, RenderOpts(**OPTS))
        assert img.dtype == np.uint8 and img.shape == (H, W, 3)
        np.testing.assert_array_equal(img, ref)
        assert img.max() > 100
        assert st["type"] == "stats" and st["render_ms"] > 0
        assert st["encode_ms"] > 0 and st["pipelined"] is True
    for _, st in frames[:2]:
        assert st["measured"] is False and st["rays"] == W * H * 2
        assert st["intersects"] == 0


def test_served_frame_matches_jax(scene_dir, served):
    _, frames = served
    j = jscene.load_scene(os.path.join(scene_dir, "city.obj"),
                          cache_dir=None,
                          lights=JLight.make(LIGHT["pos"], LIGHT["color"],
                                             LIGHT["radius"]))
    for (img, _), (pos, target) in zip(frames[:2], CAMS):
        jimg = jfast.render_frame_fast.__wrapped__(
            j, JCamera.look_at(pos=pos, target=target), W, H,
            JRenderOpts(**OPTS))
        ref = np.clip(np.asarray(jimg) * 255.0, 0, 255).astype(np.uint8)
        off = np.abs(img.astype(int) - ref.astype(int)).max(-1) > 1
        assert off.mean() <= 0.002, off.mean()


def test_served_stats_equal_counters(scene_dir, served):
    """The stats frame's counters are the counter frame's
    (render_frame_fast_stats) through tree_stats_from_counters, with the
    frame's light count."""
    _, frames = served
    img, st = frames[2]
    scene = _port_scene(scene_dir)
    cam = Camera.look_at(pos=CAMS[0][0], target=CAMS[0][1], device="cpu")
    ref, counts = render_frame_fast_stats(
        scene, cam, W, H, RenderOpts(stats=True, **OPTS))
    np.testing.assert_array_equal(img, to_rgb8(ref))
    want = tree_stats_from_counters(counts, 1).to_dict()
    assert st["measured"] is True
    for k in ("intersects", "loop_iters", "rays", "runs"):
        assert st[k] == want[k], k
    assert st["intersects"] > 0 and st["loop_iters"] > 0


@pytest.mark.parametrize("name", ["../city.obj", "/etc/passwd",
                                  "sub/../../city.obj"])
def test_scene_outside_scene_dir_refused(scene_dir, tmp_path, name):
    inner = tmp_path / "inner"
    inner.mkdir()
    s = _Session(str(inner))
    protocol.send_json(s.cli, protocol.LoadModel(name, W, H).to_json())
    msg = protocol.recv_json(s.cli)
    s.end(finish=False)
    assert msg == {"type": "error", "error": "scene outside scene_dir"}
    assert isinstance(s.error, protocol.ProtocolError)


@pytest.mark.parametrize("where", ["to_rgb8", "encode_tile"])
def test_encoder_error_ends_the_session(scene_dir, monkeypatch, where):
    """An encoder that raises (before the part stream, or in its middle)
    closes the part stream, sends an error message and ends the session:
    serve_connection raises EncoderError instead of hanging (ROADMAP
    C6)."""
    if where == "to_rgb8":
        def broken(img):
            raise RuntimeError("injected")
        monkeypatch.setattr(server, "to_rgb8", broken)
    else:
        calls, real = [], server.encode_tile

        def broken(tile):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("injected")
            return real(tile)
        monkeypatch.setattr(server, "encode_tile", broken)
    s = _Session(scene_dir, timeout=10.0)
    # two 64 x 64 parts a frame: the second one fails in "encode_tile"
    protocol.send_json(s.cli,
                       protocol.LoadModel("city.obj", 2 * W, H).to_json())
    assert protocol.recv_json(s.cli)["type"] == "model_ready"
    req = protocol.FrameRequest(cam_pos=CAMS[0][0], cam_target=CAMS[0][1],
                                lights=[LIGHT], gvals=GVALS)
    t0 = time.monotonic()
    protocol.send_json(s.cli, req.to_json())
    parts = list(protocol.recv_parts(s.cli))
    assert len(parts) == (0 if where == "to_rgb8" else 1)
    msg = protocol.recv_json(s.cli)
    assert msg["type"] == "error" and "injected" in msg["error"]
    s.end(finish=False)
    assert time.monotonic() - t0 < 10.0
    assert isinstance(s.error, server.EncoderError), s.error
    with pytest.raises(protocol.ProtocolError, match="injected"):
        client._expect(msg, "stats")


def test_stalled_encoder_does_not_hang_the_session(scene_dir, monkeypatch):
    """An encoder stuck on a frame: the frame loop's put gives up after
    the timeout and the session ends with EncoderError."""
    release = threading.Event()

    def stuck(img):
        release.wait(TIMEOUT)
        raise RuntimeError("released")
    monkeypatch.setattr(server, "to_rgb8", stuck)
    s = _Session(scene_dir, timeout=0.5)
    protocol.send_json(s.cli, protocol.LoadModel("city.obj", W, H).to_json())
    assert protocol.recv_json(s.cli)["type"] == "model_ready"
    t0 = time.monotonic()
    for _ in range(5):  # queued without waiting: the encoder takes none
        protocol.send_json(s.cli, protocol.FrameRequest(
            cam_pos=CAMS[0][0], cam_target=CAMS[0][1], lights=[LIGHT],
            gvals=GVALS).to_json())
    s.thread.join(TIMEOUT)
    assert not s.thread.is_alive()
    assert time.monotonic() - t0 < 30.0
    release.set()
    s.cli.close()
    assert isinstance(s.error, server.EncoderError), s.error


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_client_against_server_main(scene_dir, tmp_path):
    """``server.main(["--once", ...])`` on 127.0.0.1 and ``run_client``:
    every frame (orbiting camera) and its PNG equal the port's frame of
    the request's camera, and the server exits 0."""
    port = _free_port()
    rc = []
    th = threading.Thread(target=lambda: rc.append(server.main(
        ["--once", "--port", str(port), "--scene-dir", scene_dir,
         "--device", "cpu"])), daemon=True)
    th.start()
    scene = _port_scene(scene_dir)
    seen = []

    def on_frame(f, req, img, st, dt, kb):
        seen.append(f)
        ref = _reference(scene, req.cam_pos, req.cam_target, RenderOpts())
        np.testing.assert_array_equal(img, ref)
        assert st["measured"] is True  # the stats toggle on 64 x 64
        assert dt > 0 and 0 < kb < W * H * 3 / 1024

    deadline = time.monotonic() + TIMEOUT
    while True:
        try:
            acc = client.run_client(
                "127.0.0.1", port, "city.obj", W, H, 2, CAMS[0][0],
                CAMS[0][1], [LIGHT], str(tmp_path / "frame"), stats=True,
                on_frame=on_frame)
            break
        except ConnectionRefusedError:  # the server is not listening yet
            assert time.monotonic() < deadline
            time.sleep(0.05)
    th.join(TIMEOUT)
    assert not th.is_alive() and rc == [0]
    assert seen == [0, 1] and acc.frames == 2 and acc.fps_max > 0
    from PIL import Image
    for f in range(2):
        png = np.asarray(Image.open(tmp_path / f"frame_{f:03d}.png"))
        assert png.shape == (H, W, 3) and png.max() > 100


def test_rtracer_writes_the_renderer_frames(scene_dir, tmp_path, capsys):
    """``rtracer.main`` on the CPU: each PNG is the frame ``Renderer``
    renders for its orbit camera, and it prints the FrameCounter's fps."""
    from PIL import Image

    from snail_tpu_torch.utils.image import save_image

    out = tmp_path / "out"
    rtracer.main([os.path.join(scene_dir, "city.obj"), "-r", f"{W}x{H}",
                  "--frames", "2", "--out-dir", str(out), "--device", "cpu",
                  "--no-reflections", "--cam", "6,7,9:0,1,0",
                  "--light", "0,15,0:1,1,1:60"])
    assert "avg fps" in capsys.readouterr().out
    scene = _port_scene(scene_dir)
    r = Renderer(scene, W, H, RenderOpts(reflections=False,
                                         transparency=False))
    tgt = np.array([0.0, 1.0, 0.0])
    for f in range(2):
        pos = client.orbit_pos(tgt, np.array([6.0, 7.0, 9.0]) - tgt, f, 2)
        img = r.render(Camera.look_at(pos=tuple(pos), target=tuple(tgt),
                                      device="cpu"))
        save_image(str(tmp_path / "ref.png"), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / f"output_{f:03d}.png")),
            np.asarray(Image.open(tmp_path / "ref.png")))
    assert r.fps.fps > 0


def test_light_stack_and_with_lights_match_jax():
    a = Light.make((0, 1, 2), (1, 1, 1), 5.0, device="cpu")
    b = Light.make((3, 4, 5), (0.5, 0.2, 1), 7.0, device="cpu")
    ja = JLight.make((0, 1, 2), (1, 1, 1), 5.0)
    jb = JLight.make((3, 4, 5), (0.5, 0.2, 1), 7.0)
    s, js = Light.stack([a, b]), JLight.stack([ja, jb])
    for k in ("pos", "color", "radius"):
        np.testing.assert_array_equal(getattr(s, k).numpy(),
                                      np.asarray(getattr(js, k)))
    assert len(s) == 2
    from snail_tpu_torch.bvh import build_bvh
    from snail_tpu_torch.scene.procedural import cornell_scene
    from snail_tpu_torch.scene.scene import make_traced_scene

    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    scene = make_traced_scene(g, build_bvh(lo, hi, leaf_size=8), lights=a,
                              device="cpu")
    two = scene.with_lights(s)
    assert two.lights is s and len(scene.lights) == 1
    assert two.tri_rows is scene.tri_rows
