"""Spans and counters inside the program, on the profiler's clock.

Off by default. Then :func:`span` returns one shared null context after
one check of a module flag, and :func:`count` records nothing: no
``record_function``, no device operation, no sync. Inside
:func:`tracing`, each span is a ``torch.profiler.record_function`` range,
so that under ``torch.profiler`` its events land in the same Chrome trace,
on the same clock, as the device's kernels, and each counter keeps its
values as 0-d tensors on their device until :func:`counters` reads them
with one sync.

The spans, all named ``snail.<stage>``:

  snail.frame     ``render.renderer.render_frame``: the whole frame
  snail.rgb8      ``render.renderer.to_rgb8``: conversion and copy out
  snail.forward   ``diff.render_loss_and_grads``: render and loss
  snail.backward  the same: ``torch.autograd.grad``
  snail.camera    the primary wavefront (``ops.traverse.camera_trace``)
  snail.shadow    a light's shadow wavefront (``any_hit_shared``, the
                  frame's ``_lights``), any-hits of the dispatch seam
  snail.closest   a bounce wavefront's closest hit (``closest_hit_c``)
  snail.gather    the shading rows' gathers (``render.fast``: the hit-row
                  gather's kernel, the differentiable frame's pack)
  snail.shade     one traced wavefront's shading, its bounces inside
  snail.rows      a shared-origin triangle table's build
                  (``ops.traverse.shared_rows``: the leaf-table counter
                  frame's camera and light tables for B8a/B8b; the walk
                  kernels test the raw rows), inside ``snail.camera`` or
                  ``snail.shadow``

A stage entered inside itself (a wrapper calling the entry point it
wraps, a bounce depth's shading inside its parent's) stays one span.

The counters: ``rays.traced``, each wavefront's rays as handed to the
kernels, and ``rays.live``, those with tmax >= 0 (every primary ray);
``gather.rows``, each hit-row gather's rays (``ops.gather.surface_rows``),
and ``gather.cols``, its columns, summed over the gathers (host ints);
``rows.tris``, the rows of each shared-origin table built, a scene's
triangles and their pad rows (host ints).

:class:`SpanIndex` reads an exported trace back: each device operation
belongs to the innermost span around its launch, and a backward kernel to
the span of the forward operation that made it.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from collections import defaultdict
from typing import Optional

import torch

PREFIX = "snail."
ROOTS = ("snail.frame", "snail.forward")  # counted, for per-frame means
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_BACKWARD = "autograd::engine::evaluate_function: "

_on = False
_NULL = contextlib.nullcontext()
_counts: dict = {}
_local = threading.local()


def active() -> bool:
    """Whether tracing is on."""
    return _on


def span(name: str):
    """A context manager for the stage ``name``: a ``record_function``
    range while tracing is on, else a shared null context."""
    if not _on:
        return _NULL
    return _open(name)


@contextlib.contextmanager
def _open(name: str):
    stack = _local.__dict__.setdefault("stack", [])
    if stack and stack[-1] == name:
        yield
        return
    if name in ROOTS:
        count(name, 1)
    stack.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()


def count(name: str, n) -> None:
    """Adds ``n``, an int or a 0-d tensor left on its device, to the
    counter ``name`` while tracing is on."""
    if _on:
        _counts.setdefault(name, []).append(n)


@contextlib.contextmanager
def tracing():
    """Tracing on within the block, the counters cleared on entry."""
    global _on
    _counts.clear()
    _on = True
    try:
        yield
    finally:
        _on = False


def counters() -> dict:
    """The counters' sums over the last :func:`tracing` block, and the
    number of each root span (:data:`ROOTS`) opened in it, as ints: one
    host sync for all the counters kept on a device."""
    out, dev = {}, {}
    for name, vals in _counts.items():
        out[name] = sum(v for v in vals if not isinstance(v, torch.Tensor))
        ts = [v for v in vals if isinstance(v, torch.Tensor)]
        if ts:
            dev[name] = torch.stack(ts).sum()
    if dev:
        for name, v in zip(dev, torch.stack(list(dev.values())).tolist()):
            out[name] += int(v)
    return out


# ------------------------------------------------------ reading a trace


class _Nest:
    """Properly nested intervals (start, end, value) of one thread: the
    innermost one that covers a time."""

    def __init__(self, rows):
        self.rows = sorted(rows, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.rows]
        self.parent, stack = [], []
        for i, (start, _, _) in enumerate(self.rows):
            while stack and self.rows[stack[-1]][1] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float):
        """The innermost row with start <= t < end, or None."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.rows[j][1] <= t:
            j = self.parent[j]
        return None if j < 0 else self.rows[j]


class SpanIndex:
    """The program's spans in a Chrome trace exported by
    ``torch.profiler`` with host activity on, and the span of each host
    event and device operation in it.

    A device operation is found at its launch by the ``correlation`` it
    shares with a runtime call. Host time ``t`` on a thread belongs to the
    innermost ``snail.`` span of that thread around it, unless it lies
    inside a backward function (``autograd::engine::evaluate_function``):
    then it belongs to the span of the forward operation that made the
    backward function, where the trace has it: the last forward operation
    (``Fwd thread id`` 0) with the same ``Sequence number`` (each forward
    operation records the number that the next backward function will
    take, and making one takes it). What neither rule places (the
    autograd engine's own kernels, on its own thread) belongs to the
    innermost span that any thread has open at ``t``: ``snail.backward``.
    """

    def __init__(self, chrome: dict):
        spans, backward = defaultdict(list), defaultdict(list)
        forward, self.launches, self.device = {}, {}, []
        for e in chrome.get("traceEvents", ()):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name, args = e.get("cat", ""), e["name"], e.get("args", {})
            key = (e.get("pid"), e.get("tid"))
            ts = float(e["ts"])
            end = ts + float(e["dur"])
            if cat in DEVICE_CATS:
                self.device.append((name, cat, ts, float(e["dur"]),
                                    args.get("correlation")))
            elif cat == "user_annotation" and name.startswith(PREFIX):
                spans[key].append((ts, end, name))
            elif cat in ("cuda_runtime", "cuda_driver") \
                    and "correlation" in args:
                self.launches[args["correlation"]] = (key, ts)
            elif cat == "cpu_op" and "Sequence number" in args:
                seq = args["Sequence number"]
                if name.startswith(_BACKWARD):
                    backward[key].append((ts, end, seq))
                elif args.get("Fwd thread id", 0) == 0 and (
                        seq not in forward or ts > forward[seq][1]):
                    forward[seq] = (key, ts)
        self.spans = {k: _Nest(v) for k, v in spans.items()}
        self._backward = {k: _Nest(v) for k, v in backward.items()}
        self._forward = forward

    def _on_thread(self, key, t: float) -> Optional[str]:
        nest = self.spans.get(key)
        row = None if nest is None else nest.at(t)
        return None if row is None else row[2]

    def at(self, key, t: float) -> Optional[str]:
        """The span of host time ``t`` on the thread ``key`` (pid, tid)."""
        nest = self._backward.get(key)
        bwd = None if nest is None else nest.at(t)
        if bwd is not None and bwd[2] in self._forward:
            name = self._on_thread(*self._forward[bwd[2]])
            if name is not None:
                return name
        name = self._on_thread(key, t)
        if name is not None:
            return name
        rows = [r for r in (n.at(t) for n in self.spans.values()) if r]
        return min(rows, key=lambda r: r[1] - r[0])[2] if rows else None

    def device_ops(self):
        """Each device operation as (name, cat, ts, dur, span); span None
        where its launch is not in the trace or lies outside every
        span."""
        out = []
        for name, cat, ts, dur, corr in self.device:
            at = self.launches.get(corr)
            out.append((name, cat, ts, dur,
                        None if at is None else self.at(*at)))
        return out

    def device_us(self) -> dict:
        """Device time (us) by span, None for what no span holds."""
        out = defaultdict(float)
        for _, _, _, dur, name in self.device_ops():
            out[name] += dur
        return dict(out)
