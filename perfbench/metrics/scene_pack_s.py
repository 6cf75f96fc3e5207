"""Seconds to pack the scene onto the card (``make_traced_scene``, then a
synchronise), a span of the benchmark's set-up."""


def read(run):
    return run.host.get("scene_pack_s")
