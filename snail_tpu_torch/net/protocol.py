"""Client <-> render-server frame protocol over TCP; a copy of
``snail_tpu.net.protocol`` (the same bytes on the wire).

Rebuild of the reference's wire protocol (comm.h:8-76 stream operators;
LoadNewModel handshake comm.h:149-156; per-frame request client.cpp:121-128
``finish, camera, lights, gVals, threads, nInstances, animPos``; tile
stream with {x,y,w,h,size} part headers compression.h:6-9 terminated by a
0 sentinel server.cpp:401; stats trailer server.cpp:403-418).

All integers little-endian. Messages are length-prefixed JSON for the
small config records (LoadModel / FrameRequest / Stats — these are ~100 B
per frame, exactly like the reference's config broadcast) and raw binary
for tile payloads (the actual bandwidth).
"""

from __future__ import annotations

import json
import socket
import struct
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_PORT = 20002  # client.cpp:187

# Hard cap on any length-prefixed message/payload: a malicious or corrupt
# u32 prefix must not be able to force a multi-GB allocation.
MAX_MSG = 64 * 1024 * 1024


class ProtocolError(Exception):
    pass

# The reference serves blockWidth x blockHeight = 16 x 64 parts
# (rtbase_math.h:30-33). The packed frame shades 64 x 64 tiles, so
# parts default to 64 x 64 (one tile per part).
PART_W = 64
PART_H = 64


def _send_all(sock: socket.socket, data: bytes) -> None:
    sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def send_json(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    _send_all(sock, struct.pack("<I", len(data)) + data)


def recv_json(sock: socket.socket) -> dict:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    if n > MAX_MSG:
        raise ProtocolError(f"message length {n} exceeds cap {MAX_MSG}")
    return json.loads(_recv_exact(sock, n))


@dataclass
class LoadModel:
    """LoadNewModel (comm.h:149-156)."""

    name: str
    resx: int
    resy: int
    rebuild: bool = False
    flip_normals: bool = True
    swap_yz: bool = False

    def to_json(self):
        return {"type": "load_model", **asdict(self)}


@dataclass
class FrameRequest:
    """Per-frame config (client.cpp:121-128). ``gvals`` maps to
    RenderOpts toggles; camera is pos+front+up (9 floats like the
    reference's Camera struct, camera.h:7-14)."""

    finish: bool = False
    cam_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cam_target: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    lights: List[dict] = field(default_factory=list)
    gvals: dict = field(default_factory=dict)
    threads: int = 0  # ignored: the device runs the frame; kept for parity
    n_instances: int = 0
    anim_pos: float = 0.0

    def to_json(self):
        return {"type": "frame", **asdict(self)}


PART_HDR = struct.Struct("<HHHHBxi")  # x, y, w, h, codec, pad, raw_len


def send_parts(sock: socket.socket, parts) -> None:
    """parts: iterable of (x, y, w, h, codec_id, raw_len, payload).
    Ends with the 0 sentinel (server.cpp:401)."""
    for (x, y, w, h, cid, raw_len, payload) in parts:
        hdr = PART_HDR.pack(x, y, w, h, cid, raw_len)
        _send_all(sock, struct.pack("<I", len(payload)) + hdr + payload)
    _send_all(sock, struct.pack("<I", 0))


def recv_parts(sock: socket.socket):
    """Yields (x, y, w, h, codec_id, raw_len, payload) until sentinel."""
    while True:
        (n,) = struct.unpack("<I", _recv_exact(sock, 4))
        if n == 0:
            return
        if n > MAX_MSG:
            raise ProtocolError(f"part length {n} exceeds cap {MAX_MSG}")
        hdr = _recv_exact(sock, PART_HDR.size)
        x, y, w, h, cid, raw_len = PART_HDR.unpack(hdr)
        if raw_len > MAX_MSG or raw_len < 0:
            raise ProtocolError(f"part raw_len {raw_len} exceeds cap")
        yield x, y, w, h, cid, raw_len, _recv_exact(sock, n)


def assemble(parts, height: int, width: int) -> np.ndarray:
    """Reassemble decoded parts into the framebuffer (client.cpp:307-333)."""
    from .codec import decode_tile

    img = np.zeros((height, width, 3), np.uint8)
    for (x, y, w, h, cid, raw_len, payload) in parts:
        img[y:y + h, x:x + w] = decode_tile(cid, raw_len, payload, h, w)
    return img
