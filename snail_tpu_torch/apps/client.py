"""Viewer client (``snail_tpu.apps.client``): requests frames from the
render server over TCP.

Rebuild of the reference's GLFW client (client.cpp:130-396) minus the GL
window (headless): frames are decompressed, reassembled and written as
PNGs; the HUD becomes printed stat lines with the same min/max/avg FPS +
MRays/s accounting (client.cpp:215-252, 374-379). The client renders
nothing: the server's ``--device`` decides where frames render.

Run: ``python -m snail_tpu_torch.apps.client city.obj --host HOST
--frames 8``
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import time

import numpy as np

from ..net import protocol
from ..utils.frame_counter import FrameCounter
from ..utils.image import save_image


class StatAccum:
    """min/max/avg FPS + MRays/s accumulation; 'X' reset key semantics
    (client.cpp:239-253) -> reset() method."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.frames = 0
        self.t_sum = 0.0
        self.fps_min = float("inf")
        self.fps_max = 0.0
        self.mrays_sum = 0.0

    def tick(self, dt: float, rays: int):
        fps = 1.0 / max(dt, 1e-9)
        self.frames += 1
        self.t_sum += dt
        self.fps_min = min(self.fps_min, fps)
        self.fps_max = max(self.fps_max, fps)
        self.mrays_sum += rays / max(dt, 1e-9) / 1e6

    def summary(self) -> str:
        if not self.frames:
            return "no frames"
        avg_fps = self.frames / self.t_sum
        return (f"frames:{self.frames} fps(min/avg/max): "
                f"{self.fps_min:.2f}/{avg_fps:.2f}/{self.fps_max:.2f} "
                f"MRays/s(avg): {self.mrays_sum / self.frames:.1f}")


def run_client(host: str, port: int, model: str, resx: int, resy: int,
               frames: int, cam_pos, cam_target, lights,
               out_prefix=None, stats: bool = False,
               on_frame=None) -> StatAccum:
    """One session: load ``model`` (resolved by the server in its scene
    directory), request ``frames`` frames on an orbit around
    ``cam_target``, reassemble each and write it as
    ``{out_prefix}_{f:03d}.png`` (None: no files). ``on_frame(f, request,
    image, stats, seconds, kb)`` sees each frame: its ``FrameRequest``, the
    (resy, resx, 3) uint8 image, the server's stats message, the seconds
    from request to image and the KB of its parts. An ``error`` message
    from the server raises ``protocol.ProtocolError``."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.connect((host, port))
        protocol.send_json(sock,
                           protocol.LoadModel(model, resx, resy).to_json())
        ready = _expect(protocol.recv_json(sock), "model_ready")
        print(f"[client] model ready: {ready['num_tris']} tris, "
              f"build {ready['build_time']:.2f}s", flush=True)

        acc = StatAccum()
        fc = FrameCounter()
        orbit = np.asarray(cam_pos, np.float64) - np.asarray(cam_target)
        for f in range(frames):
            # orbit the camera (the client's anim loop feel)
            pos = orbit_pos(np.asarray(cam_target), orbit, f, frames)
            req = protocol.FrameRequest(
                cam_pos=tuple(map(float, pos)),
                cam_target=tuple(map(float, cam_target)),
                lights=lights,
                gvals={"2": True} if stats else {},
            )
            t0 = time.perf_counter()
            protocol.send_json(sock, req.to_json())
            parts = list(protocol.recv_parts(sock))
            st = _expect(protocol.recv_json(sock), "stats")
            img = protocol.assemble(parts, resy, resx)
            dt = time.perf_counter() - t0
            rays = resx * resy * (1 + len(lights))
            acc.tick(dt, rays)
            fc.tick()
            kb = sum(len(p[6]) for p in parts) / 1024.0
            hud = ""
            if st.get("measured"):
                # measured in-kernel counters (TreeStats::GenInfo HUD
                # string, reference tree_stats.cpp GenInfo /
                # client.cpp:352)
                hud = (f" in:{st['intersects'] // 1000}k"
                       f" it:{st['loop_iters'] // 1000}k")
            print(f"[client] frame {f}: {dt*1e3:.1f} ms "
                  f"(render {st['render_ms']:.1f} ms, {kb:.0f} KB/frame)"
                  f"{hud}", flush=True)
            if out_prefix:
                save_image(f"{out_prefix}_{f:03d}.png", img)
            if on_frame is not None:
                on_frame(f, req, img, st, dt, kb)
        protocol.send_json(sock, {"type": "finish", "finish": True})
    finally:
        sock.close()
    print("[client]", acc.summary(), flush=True)
    return acc


def orbit_pos(target, orbit, f: int, frames: int) -> np.ndarray:
    """Frame f's camera position: ``orbit`` (position - target) turned
    about the y axis by a tenth of a circle over ``frames`` frames."""
    ang = 2.0 * np.pi * f / max(frames, 1) * 0.1
    c, s = np.cos(ang), np.sin(ang)
    return target + np.array([orbit[0] * c + orbit[2] * s, orbit[1],
                              -orbit[0] * s + orbit[2] * c])


def _expect(msg: dict, kind: str) -> dict:
    if msg.get("type") != kind:
        raise protocol.ProtocolError(
            f"expected {kind}, the server sent {msg.get('type')!r}: "
            f"{msg.get('error', '')}")
    return msg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="snail_tpu_torch viewer client")
    ap.add_argument("model", help="scene file (server resolves rel paths)")
    ap.add_argument("--host", default="127.0.0.1")  # "blader" default in
    # the reference (readme_distributed.txt:24-25) -> localhost here
    ap.add_argument("--port", type=int, default=protocol.DEFAULT_PORT)
    ap.add_argument("--res", default="512x512")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--cam-pos", default="3,2.5,4")
    ap.add_argument("--cam-target", default="0,0,0")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "snail_frame"),
                    help="PNG prefix of the frames ('' writes none)")
    ap.add_argument("--stats", action="store_true",
                    help="request measured in-kernel TreeStats (gVals[2])")
    args = ap.parse_args(argv)
    resx, resy = map(int, args.res.split("x"))
    cam_pos = tuple(map(float, args.cam_pos.split(",")))
    cam_target = tuple(map(float, args.cam_target.split(",")))
    lights = [{"pos": [5.0, 15.0, 5.0], "color": [1, 1, 1], "radius": 60.0}]
    run_client(args.host, args.port, args.model, resx, resy, args.frames,
               cam_pos, cam_target, lights, args.out or None,
               stats=args.stats)


if __name__ == "__main__":
    main()
