"""Render server (``snail_tpu.apps.server``): owns a device and serves
frames to a TCP client.

Rebuild of the reference's server+node pair (server.cpp:192-429,
node.cpp:210-390). Where the reference splits the image into 16x64 parts
and round-robins them over MPI ranks (DivideImage server.cpp:178-190),
here one device renders the frame and the server compresses finished
64x64 parts with the native codec and streams them to the client: the
quicklz tile relay (server.cpp:389-401) without the MPI hop.

Frames render on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``). A frame with the stats toggle
(gVals[2]) whose size the counter frame takes renders through it and
sends its measured counters (``utils.stats.tree_stats_from_counters``).

Run: ``python -m snail_tpu_torch.apps.server --scene-dir DIR [--port
20002] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import sys
import threading
import time

import numpy as np

from ..core.types import Camera, Light, RenderOpts
from ..net import protocol
from ..net.codec import encode_tile
from ..ops.traverse import TILE
from ..render.fast import render_frame_fast_stats, stats_path_available
from ..render.renderer import render_frame, to_rgb8
from ..scene.scene import load_scene
from ..utils.stats import TreeStats, tree_stats_from_counters

# the longest the frame loop waits to hand a frame to the encoder thread,
# and to see it finish at the end of a session
ENCODER_TIMEOUT_S = 60.0


class EncoderError(RuntimeError):
    """The encoder thread failed or stalled; the session ends with it."""


def _opts_from_gvals(gvals: dict) -> RenderOpts:
    """gVals (rtbase.h:31, F-key toggles broadcast per frame,
    client.cpp:283-292) -> RenderOpts. Known slots follow the observed
    semantics in SURVEY.md §5: [2]=stats, [4]=no-shading distance view,
    [5]=reflections, [9]=supersampling."""
    return RenderOpts(
        stats=bool(gvals.get("2", gvals.get("stats", False))),
        shading=not gvals.get("4", gvals.get("no_shading", False)),
        reflections=bool(gvals.get("5", gvals.get("reflections", True))),
        supersample=bool(gvals.get("9", gvals.get("supersample", False))),
        shadows=bool(gvals.get("shadows", True)),
        transparency=bool(gvals.get("transparency", True)),
        textures=bool(gvals.get("textures", True)),
    )


def _split_parts(rgb8: np.ndarray):
    """Cut the frame into PART_W x PART_H tiles + encode (DivideImage,
    server.cpp:178-190; per-part headers compression.h:6-9)."""
    h, w, _ = rgb8.shape
    pw, ph = protocol.PART_W, protocol.PART_H
    for y in range(0, h, ph):
        for x in range(0, w, pw):
            tile = rgb8[y:y + ph, x:x + pw]
            cid, raw_len, payload = encode_tile(tile)
            yield x, y, tile.shape[1], tile.shape[0], cid, raw_len, payload


def _counted(scene, width: int, height: int, opts: RenderOpts) -> bool:
    """Whether a frame with the stats toggle renders through the counter
    frame (``render_frame_fast_stats``): a scene it can count
    (``stats_path_available``) at a size it takes, whole 64-pixel tiles
    and no supersampling (it renders no supersampled frame)."""
    return (opts.stats and stats_path_available(scene)
            and width % TILE == 0 and height % TILE == 0
            and not opts.supersample)


class _Encoder:
    """The encode/send worker of one session. It converts, compresses and
    streams frame n's parts while the device renders frame n+1: the
    reference overlaps quicklz compression of finished tiles with the
    rendering of later tiles the same way (render_spu.cpp:31-33). The
    frame loop only queues a frame's work on the device's stream and hands
    the image to this thread, whose ``to_rgb8`` (a copy to the host on the
    same default stream) waits for it; the queue holds the image until
    then. One thread drains the queue in order, so the protocol's order
    holds.

    A failure here is sent to the client as an ``error`` message (after
    the 0 sentinel if a part stream was open), the connection is shut
    down so that the frame loop's receive returns, and :meth:`put` and
    :meth:`close` raise :class:`EncoderError`; every wait is bounded by
    ``timeout`` seconds."""

    def __init__(self, conn: socket.socket, build_time: float,
                 timeout: float):
        self.conn = conn
        self.build_time = build_time
        self.timeout = timeout
        self.queue: "queue.Queue" = queue.Queue(maxsize=2)
        self.error = None
        self.parts_open = False  # a frame's part stream is not closed
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def put(self, item) -> None:
        deadline = time.monotonic() + self.timeout
        while True:
            self._raise_error()
            try:
                self.queue.put(item, timeout=0.1)
                return
            except queue.Full:
                if time.monotonic() > deadline:
                    raise EncoderError(f"the encoder took no frame in "
                                       f"{self.timeout} s") from None

    def close(self) -> None:
        """Let the encoder send what it holds, then stop it."""
        try:
            self.queue.put(None, timeout=self.timeout)
        except queue.Full:
            pass  # a dead encoder holds a full queue; the join says so
        self.thread.join(self.timeout)
        self._raise_error()
        if self.thread.is_alive():
            raise EncoderError(f"the encoder did not finish in "
                               f"{self.timeout} s")

    def _raise_error(self) -> None:
        if self.error is not None:
            raise EncoderError(f"the encoder failed: {self.error!r}"
                               ) from self.error

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            try:
                self._send(*item)
            except Exception as e:  # the session's boundary: report, end
                self.error = e
                self._report(e)
                return

    def _send(self, img, t0, kstats, rays, n_lights) -> None:
        self.parts_open = True  # the client waits for the part stream
        te0 = time.perf_counter()
        rgb8 = to_rgb8(img)  # waits for the frame on the device
        render_ms = (time.perf_counter() - t0) * 1e3
        protocol.send_parts(self.conn, _split_parts(rgb8))
        self.parts_open = False
        encode_ms = (time.perf_counter() - te0) * 1e3
        if kstats is not None:
            stats = tree_stats_from_counters(kstats, n_lights)
        else:
            stats = TreeStats(rays=rays)
        protocol.send_json(self.conn, {
            "type": "stats", "render_ms": render_ms,
            "encode_ms": encode_ms, "pipelined": True,
            "measured": kstats is not None,
            "build_ms": self.build_time * 1e3, **stats.to_dict(),
        })

    def _report(self, e: Exception) -> None:
        try:
            if self.parts_open:
                protocol.send_parts(self.conn, [])
            protocol.send_json(self.conn, {"type": "error",
                                           "error": f"encoder: {e!r}"})
        except OSError:
            pass  # the connection itself failed
        try:
            self.conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


def _scene_path(conn: socket.socket, scene_dir: str, name: str) -> str:
    """Scene names resolve strictly inside scene_dir: a client-supplied
    absolute or ..-escaping path must not become an arbitrary file read."""
    base = os.path.realpath(scene_dir)
    path = os.path.realpath(os.path.join(base, name))
    if not (path == base or path.startswith(base + os.sep)):
        protocol.send_json(conn, {"type": "error",
                                  "error": "scene outside scene_dir"})
        raise protocol.ProtocolError(f"scene path escape: {name!r}")
    return path


def serve_connection(conn: socket.socket, scene_dir: str,
                     cache_dir=None, device="cuda",
                     timeout: float = ENCODER_TIMEOUT_S) -> None:
    """One client session: LoadNewModel handshake then the frame loop
    (server.cpp:217, 356-418), the scene and its frames on ``device``.
    Raises :class:`EncoderError` if the encoder thread failed, and
    ``protocol.ProtocolError`` on a bad handshake."""
    msg = protocol.recv_json(conn)
    if msg.get("type") != "load_model":
        protocol.send_json(conn, {"type": "error",
                                  "error": "expected load_model"})
        raise protocol.ProtocolError(f"bad handshake: {msg.get('type')!r}")
    path = _scene_path(conn, scene_dir, msg["name"])
    resx, resy = int(msg["resx"]), int(msg["resy"])

    t0 = time.perf_counter()
    scene = load_scene(path, cache_dir=cache_dir,
                       flip_normals=msg.get("flip_normals", True),
                       device=device)
    build_time = time.perf_counter() - t0
    protocol.send_json(conn, {"type": "model_ready",
                              "build_time": build_time,
                              "num_tris": int(scene.num_tris)})

    encoder = _Encoder(conn, build_time, timeout)
    try:
        _frame_loop(conn, scene, resx, resy, encoder, device)
    finally:
        encoder.close()


def _frame_loop(conn, scene, resx, resy, encoder, device) -> None:
    while True:
        req = protocol.recv_json(conn)
        if req.get("finish") or req["type"] == "finish":
            break
        cam = Camera.look_at(pos=tuple(req["cam_pos"]),
                             target=tuple(req["cam_target"]), device=device)
        lights = req.get("lights") or []
        if lights:
            scene = scene.with_lights(Light.stack(
                [Light.make(tuple(l["pos"]), tuple(l["color"]),
                            float(l["radius"]), device=device)
                 for l in lights]))
        opts = _opts_from_gvals(req.get("gvals", {}))
        # the rays and runs the frame traces: the scene's lights, which
        # the request may have replaced
        n_lights = 0 if scene.lights is None else len(scene.lights)

        t0 = time.perf_counter()
        kstats = None
        if _counted(scene, resx, resy, opts):
            # real in-kernel traversal counters (TreeStats rebuild,
            # reference tree_stats.h:36-130, aggregated server-side like
            # server.cpp:406-418); the counter frame copies them to the
            # host, so it waits for its frame
            img, kstats = render_frame_fast_stats(scene, cam, resx, resy,
                                                  opts)
        else:
            img = render_frame(scene, cam, resx, resy, opts)
        # hand the frame, queued on the device, to the encoder and go
        # straight back to recv: frame n's encode overlaps frame n+1's
        # render
        encoder.put((img, t0, kstats, resx * resy * (1 + n_lights),
                     n_lights))


def serve(srv: socket.socket, scene_dir: str, cache_dir=None,
          device="cuda", sessions=None) -> int:
    """Accept clients on the listening socket ``srv`` and serve each in
    turn (surviving client disconnects, server.cpp:210 outer loop), at
    most ``sessions`` of them (None: until interrupted); closes ``srv``.
    Returns 0 if every session ended as the client asked, else 1."""
    failed = False
    try:
        n = 0
        while sessions is None or n < sessions:
            conn, addr = srv.accept()
            n += 1
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            print(f"[server] client {addr}", flush=True)
            try:
                serve_connection(conn, scene_dir, cache_dir, device)
            except (OSError, protocol.ProtocolError, EncoderError) as e:
                print(f"[server] session ended: {e!r}", flush=True)
                failed = True
            finally:
                conn.close()
    finally:
        srv.close()
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="snail_tpu_torch render server")
    ap.add_argument("--port", type=int, default=protocol.DEFAULT_PORT)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (loopback by default; pass 0.0.0.0 "
                         "explicitly to expose the unauthenticated server)")
    ap.add_argument("--scene-dir", required=True,
                    help="the directory that scene names resolve in")
    ap.add_argument("--cache-dir", default=None,
                    help="geometry and BVH cache (default: none)")
    ap.add_argument("--device", default="cuda",
                    help="device the frames render on (cuda or cpu)")
    ap.add_argument("--once", action="store_true",
                    help="serve one connection then exit (tests)")
    args = ap.parse_args(argv)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(1)
    print(f"[server] listening on {args.host}:{args.port}", flush=True)
    return serve(srv, args.scene_dir, args.cache_dir, args.device,
                 1 if args.once else None)


if __name__ == "__main__":
    sys.exit(main())
