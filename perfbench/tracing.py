"""Reading the profiler's trace of a traced window into what the per-layer
readers take (``Trace``), and the ``breakdown`` of the result line.

The window is traced with ``torch.profiler`` (host and device
activities) and exported as a Chrome trace; the benchmark's own spans
are ``record_function`` ranges around each frame or step and the calls
inside it. Times are in microseconds on the trace's clock.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"
SPANS = ("frame", "step", "camera", "render_frame", "to_rgb8", "loss_and_grads",
         "loss_readback")


@dataclasses.dataclass
class Trace:
    """One traced window: the device's operations (name, cat, ts, dur),
    the benchmark's spans and the host's other operations (name, ts,
    dur), the window's bounds (from the first iteration span's start to
    the last one's end), the count of frames or steps in it, and the
    program's own kernel names."""

    device_ops: list
    spans: list
    host_ops: list
    start: float
    end: float
    iters: int
    port_kernels: frozenset

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        return sum(e - s for s, e in _merged(self.device_ops, self.start,
                                               self.end))

    def is_port_kernel(self, name: str) -> bool:
        """Whether a device operation is one of the program's own kernels
        (its name, a whole word, before its template or argument list)."""
        if not hasattr(self, "_port_re"):
            words = "|".join(sorted(self.port_kernels)) or "(?!)"
            self._port_re = re.compile(rf"(?<!\w)(?:{words})\s*[<(]")
        return self._port_re.search(name) is not None


def port_kernel_names(csrc: Path) -> frozenset:
    """The names of the ``__global__`` functions of the program's CUDA
    sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")
    return frozenset(m.group(1) for f in sorted(csrc.glob("*.cu"))
                     for m in pat.finditer(f.read_text()))


def _merged(ops, start, end):
    """Union of the device operations' intervals, clipped to the window."""
    iv = sorted((max(ts, start), min(ts + dur, end)) for _, _, ts, dur in ops
                if ts + dur > start and ts < end)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def parse(chrome: dict, iter_span: str, port_kernels, window_us=None,
          iters=None) -> Trace:
    """A :class:`Trace` from an exported Chrome trace whose iterations are
    the spans named ``iter_span``; or, for a trace of the device alone,
    ``iters`` iterations that took ``window_us`` on the host's clock,
    from the first device operation on."""
    dev, spans, host = [], [], []
    for e in chrome.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, row = e.get("cat", ""), (e["name"], float(e["ts"]),
                                      float(e["dur"]))
        if cat in DEVICE_CATS:
            dev.append((row[0], cat, row[1], row[2]))
        elif cat == SPAN_CAT and e["name"] in SPANS:
            spans.append(row)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append(row)
    its = [s for s in spans if s[0] == iter_span]
    if window_us is None:
        start = min(s[1] for s in its) if its else 0.0
        end = max(s[1] + s[2] for s in its) if its else 0.0
        iters = len(its)
    else:
        start = min((o[2] for o in dev), default=0.0)
        end = start + window_us
    dev = [o for o in dev if o[2] + o[3] > start and o[2] < end]
    return Trace(dev, spans, host, start, end, iters,
                 frozenset(port_kernels))


def _innermost(rows, t):
    """Name of the shortest of ``rows`` that covers time ``t``."""
    best = None
    for name, ts, dur in rows:
        if ts <= t < ts + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return None if best is None else best[0]


def breakdown(tr: Trace, host: Trace, top: int = 10) -> dict:
    """The device operations that took most time in ``tr`` and the longest
    idle gaps of ``host`` (a trace with the host's operations), each gap
    named by the benchmark's innermost span and the host operation under
    way where it begins: {"device_ops": [[name, s]], "idle_gaps": [[name,
    s]]}."""
    by_name = {}
    for name, _, _, dur in tr.device_ops:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    tr = host
    busy = _merged(tr.device_ops, tr.start, tr.end)
    edges = [tr.start] + [x for iv in busy for x in iv] + [tr.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        span = _innermost(tr.spans, s) or "outside"
        op = _innermost(tr.host_ops, s)
        named.append([span if op is None else f"{span}/{op}"[:96],
                      (e - s) * 1e-6])
    return {"device_ops": [[n[:96], us * 1e-6] for n, us in ops],
            "idle_gaps": named}
