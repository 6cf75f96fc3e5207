"""The port's host network layer (``snail_tpu_torch.net``) against its
original (``snail_tpu.net``): the same tile bytes from the codec (native
LZ and the zlib path), the same bytes on the wire from the protocol, each
package reading what the other sent, and the native codec built from the
repository's ``native/codec.cpp`` into the port's build directory."""

import hashlib
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from snail_tpu.net import codec as jcodec
from snail_tpu.net import protocol as jprotocol
from snail_tpu_torch.net import codec, protocol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiles():
    rng = np.random.default_rng(7)
    noise = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    flat = np.full((64, 64, 3), 128, np.uint8)
    mixed = noise.copy()
    mixed[10:40, 10:40] = (30, 200, 90)
    edge = rng.integers(0, 256, (17, 40, 3)).astype(np.uint8)  # a last part
    return {"noise": noise, "flat": flat, "mixed": mixed, "edge": edge}


TILES = _tiles()


def _received(send, *args) -> bytes:
    """The bytes that ``send(sock, *args)`` puts on a socketpair."""
    a, b = socket.socketpair()
    b.settimeout(30)
    th = threading.Thread(target=lambda: (send(a, *args), a.close()))
    th.start()
    chunks = []
    while chunk := b.recv(1 << 16):
        chunks.append(chunk)
    th.join(timeout=30)
    b.close()
    assert not th.is_alive()
    return b"".join(chunks)


def test_native_codec_built_into_the_port():
    """The port builds the repository's native/codec.cpp (not a copy)
    with g++ into snail_tpu_torch/build/, named by the source's hash."""
    assert codec.native_available()
    so = codec._so_path()
    assert os.path.dirname(so) == os.path.join(REPO, "snail_tpu_torch",
                                               "build")
    assert os.path.exists(so)
    assert codec._SRC == os.path.join(REPO, "native", "codec.cpp")
    with open(codec._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(so) == f"libsnailcodec-{digest}.so"


def test_native_codec_builds_in_several_processes_at_once(tmp_path):
    """Test workers may build at once: each build goes to a name of its
    own and is moved into place, so every process loads a whole
    library."""
    code = ("import sys\n"
            "import snail_tpu_torch.net.codec as c\n"
            "c._BUILD = sys.argv[1]\n"
            "lib = c._build_and_bind()\n"
            "assert lib is not None\n"
            "n = lib.snail_compress(b'ab' * 500, 1000, "
            "c._as_u8ptr(__import__('numpy').empty(2000, 'uint8')), 2000)\n"
            "assert 0 < n < 1000, n\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].endswith(".so"), names


@pytest.mark.parametrize("name", sorted(TILES))
def test_encode_tile_same_bytes(name):
    tile = TILES[name]
    ours = codec.encode_tile(tile)
    assert ours == jcodec.encode_tile(tile)
    if name == "flat":
        assert ours[0] == codec.CODEC_LZ and len(ours[2]) < ours[1]
    h, w, _ = tile.shape
    np.testing.assert_array_equal(codec.decode_tile(*ours, h, w), tile)
    np.testing.assert_array_equal(jcodec.decode_tile(*ours, h, w), tile)


@pytest.mark.parametrize("name", sorted(TILES))
def test_zlib_path_same_bytes(name, monkeypatch):
    """Without the native codec both packages take the zlib path, and
    write and read the same bytes."""
    for mod in (codec, jcodec):
        monkeypatch.setattr(mod, "_load", lambda: None)
    tile = TILES[name]
    ours = codec.encode_tile(tile)
    assert ours == jcodec.encode_tile(tile)
    assert ours[0] in (codec.CODEC_ZLIB, codec.CODEC_RAW)
    h, w, _ = tile.shape
    np.testing.assert_array_equal(jcodec.decode_tile(*ours, h, w), tile)
    np.testing.assert_array_equal(codec.decode_tile(*ours, h, w), tile)


def test_protocol_constants_and_records_equal():
    assert (protocol.DEFAULT_PORT, protocol.MAX_MSG, protocol.PART_W,
            protocol.PART_H, protocol.PART_HDR.format) == (
        jprotocol.DEFAULT_PORT, jprotocol.MAX_MSG, jprotocol.PART_W,
        jprotocol.PART_H, jprotocol.PART_HDR.format)
    assert (codec.CODEC_RAW, codec.CODEC_LZ, codec.CODEC_ZLIB) == (
        jcodec.CODEC_RAW, jcodec.CODEC_LZ, jcodec.CODEC_ZLIB)
    assert protocol.LoadModel("a.obj", 64, 32).to_json() == \
        jprotocol.LoadModel("a.obj", 64, 32).to_json()
    kw = dict(cam_pos=(1.0, 2.0, 3.0), lights=[{"pos": [0, 1, 0]}],
              gvals={"2": True})
    assert protocol.FrameRequest(**kw).to_json() == \
        jprotocol.FrameRequest(**kw).to_json()


def _parts():
    return [(x, y, t.shape[1], t.shape[0], *codec.encode_tile(t))
            for (x, y), t in zip([(0, 0), (64, 0), (0, 64), (64, 64)],
                                 [TILES["noise"], TILES["flat"],
                                  TILES["mixed"], TILES["noise"][::-1]])]


def test_send_same_bytes():
    msg = {"type": "stats", "render_ms": 1.5, "rays": 3}
    assert _received(protocol.send_json, msg) == \
        _received(jprotocol.send_json, msg)
    parts = _parts()
    assert _received(protocol.send_parts, parts) == \
        _received(jprotocol.send_parts, parts)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_parts_read_by_the_other_package(direction):
    send, recv = ((protocol, jprotocol) if direction == "port_to_jax"
                  else (jprotocol, protocol))
    parts = _parts()
    a, b = socket.socketpair()
    b.settimeout(30)
    th = threading.Thread(target=lambda: (
        send.send_json(a, {"type": "x"}), send.send_parts(a, parts),
        a.close()))
    th.start()
    assert recv.recv_json(b) == {"type": "x"}
    got = list(recv.recv_parts(b))
    img = recv.assemble(got, 128, 128)
    th.join(timeout=30)
    b.close()
    assert not th.is_alive()
    assert got == parts
    np.testing.assert_array_equal(img, send.assemble(parts, 128, 128))
    np.testing.assert_array_equal(img[64:, 64:], TILES["noise"][::-1])
