"""Reading the profiler's trace of a run's window.

The trace is the Chrome-format file that ``torch.profiler`` exports. The
device's work is its ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events.
The host's spans (the benchmark's jobs, the port's stages, the engine's
device batches) are timed by the harness on the host's ``perf_counter``,
on every thread, and placed on the trace's clock by the window: a
``bench.window`` range that both record. Times are in seconds.
"""

from __future__ import annotations

import heapq
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def load(path: str) -> tuple[list, list]:
    """(device events, profiler ranges), each a list of (start, end,
    name)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        item = (a, a + float(e["dur"]) * 1e-6, str(e.get("name", "")))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(item)
        elif cat == "user_annotation":
            host.append(item)
    return dev, host


def window(host: list) -> tuple[float, float] | None:
    spans = [(a, b) for a, b, n in host if n == WINDOW]
    return (min(a for a, _ in spans), max(b for _, b in spans)) if spans \
        else None


def busy(dev: list, w0: float, w1: float) -> list[tuple[float, float]]:
    """The union of the device's events inside [w0, w1], merged."""
    out: list[list[float]] = []
    for a, b, _ in sorted(dev):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def by_name(dev: list, w0: float, w1: float) -> dict[str, float]:
    """Seconds of device work per event name inside the window."""
    tot: dict[str, float] = {}
    for a, b, n in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            tot[n] = tot.get(n, 0.0) + (b - a)
    return tot


def idle_by_span(busy_iv: list, host: list, w0: float,
                 w1: float) -> dict[str, float]:
    """The window's idle device time, given to the innermost host span open
    at each moment (the one opened last, on any thread), ``no_span`` where
    none is."""
    idle = []
    t = w0
    for a, b in busy_iv:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if t < w1:
        idle.append((t, w1))
    spans = sorted((a, b, n) for a, b, n in host if n != WINDOW and b > a)
    points = sorted({w0, w1} | {x for a, b, _ in spans for x in (a, b)
                                if w0 < x < w1})
    out: dict[str, float] = {}
    heap: list = []           # (-start, end, name) of the open spans
    si = 0
    ii = 0
    for x0, x1 in zip(points[:-1], points[1:]):
        while si < len(spans) and spans[si][0] <= x0:
            heapq.heappush(heap, (-spans[si][0], spans[si][1], spans[si][2]))
            si += 1
        while heap and heap[0][1] <= x0:
            heapq.heappop(heap)
        # spans that ended inside the heap (not at its top) stay until they
        # surface; skip those that are no longer open
        name = "no_span"
        for neg_a, end, n in sorted(heap):
            if end > x0:
                name = n
                break
        while ii < len(idle) and idle[ii][1] <= x0:
            ii += 1
        j = ii
        while j < len(idle) and idle[j][0] < x1:
            lo, hi = max(idle[j][0], x0), min(idle[j][1], x1)
            if hi > lo:
                out[name] = out.get(name, 0.0) + (hi - lo)
            j += 1
    return out


def summary(path: str, spans: list) -> dict:
    """What a run reports of its trace: the window, the device's busy
    seconds, the seconds per device event name, and the idle seconds per
    host span (``spans``: (start, end, name) on the host's clock, one of
    them the window)."""
    dev, ranges = load(path)
    w = window(ranges)
    mine = window(spans)
    if w is None or mine is None:
        return {}
    w0, w1 = w
    shift = w0 - mine[0]
    host = [(a + shift, b + shift, n) for a, b, n in spans]
    iv = busy(dev, w0, w1)
    return {"window_s": w1 - w0,
            "busy_s": sum(b - a for a, b in iv),
            "device_s": by_name(dev, w0, w1),
            "idle_s": idle_by_span(iv, host, w0, w1)}


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
