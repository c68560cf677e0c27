"""Observability: the tracer, RSS sampling, funnel counters.

The reference's equivalents: std::chrono stage spans + stdout reports
(src/Compressor.cpp:59-82), RSS from /proc/self/stat (src/Compressor.cpp:20-45)
and the CountStats candidate funnel (include/Consensus.h:19-35, printed at
src/Consensus.cpp:154-164).

``StageTimer`` is the port's one tracer. A compress job makes one and sets
it current (``StageTimer.active``); code below the job reaches it through
``current()`` on any thread, and gets a tracer that records nothing where
no job has set one (a grow-worker process, a direct call of a stage).
Spans are timed by ``time.perf_counter``, which is ``CLOCK_MONOTONIC`` on
Linux, the clock of the engine's ``std::chrono::steady_clock`` too, so the
engine's per-batch records (``native/engine.cpp``) and the job's Python
spans lie on one time line; ``chrome_trace`` writes it out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import os
import resource
import sys
import threading
import time

logger = logging.getLogger("nanospring_tpu_torch")

CLOCK = "CLOCK_MONOTONIC"
_JOBS = itertools.count(1)


def rss_gb() -> float:
    """Current resident set size in GB (Linux)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):
        return 0.0


def ru_maxrss_gb() -> float:
    """The process's resident high-water mark in GB (``ru_maxrss``)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


class StageTimer:
    """A job's spans and totals, from any thread.

    A span (``stage(name)``) records its name, start and end (seconds of
    ``perf_counter``), thread, parent (the index in ``spans`` of the span
    open on the same thread when it began), the job's sequence number and
    the attributes that ``note`` attaches. ``stage_s`` holds each name's
    summed seconds (the top-level stages under their own names, nested
    spans under their dotted ones) and the counters of ``add`` and
    ``peak``. A top-level stage (no parent, on the thread that made the
    tracer) records the current RSS and the high-water mark at its end,
    and only such stages print with ``report``."""

    def __init__(self, report: bool = True):
        self.stage_s: dict[str, float] = {}
        self.spans: list[dict] = []
        self.report = report
        self.job = next(_JOBS)
        self._lock = threading.Lock()
        self._open: dict[int, list[int]] = {}   # native thread id -> stack
        self._last = threading.local()          # .span: last one closed
        self._main = threading.get_native_id()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        tid = threading.get_native_id()
        thread = threading.current_thread().name
        with self._lock:
            stack = self._open.setdefault(tid, [])
            span = {"name": name, "start": time.perf_counter(), "end": None,
                    "thread": thread, "parent": stack[-1] if stack else None,
                    "job": self.job, "args": {}}
            stack.append(len(self.spans))
            self.spans.append(span)
        try:
            yield
        finally:
            end = time.perf_counter()
            top = span["parent"] is None and tid == self._main
            if top:
                span["args"].update(rss_gb=rss_gb(),
                                    ru_maxrss_gb=ru_maxrss_gb())
            dt = end - span["start"]
            with self._lock:
                stack.pop()
                span["end"] = end
                self.stage_s[name] = self.stage_s.get(name, 0.0) + dt
            self._last.span = span
            if top and self.report:
                print(f"[nstpu] {name}: {dt:.2f}s "
                      f"(rss {span['args']['rss_gb']:.2f} GB)",
                      file=sys.stderr)

    def last(self) -> dict:
        """The span that this thread closed last."""
        return self._last.span

    def note(self, **attrs) -> None:
        """Attach ``attrs`` to the innermost span open on this thread."""
        with self._lock:
            stack = self._open.get(threading.get_native_id())
            if stack:
                self.spans[stack[-1]]["args"].update(attrs)

    def add(self, name: str, value: float) -> None:
        """Add ``value`` to the counter ``name`` in ``stage_s``."""
        with self._lock:
            self.stage_s[name] = self.stage_s.get(name, 0.0) + value

    def peak(self, name: str, value: float) -> None:
        """Keep the largest ``value`` under ``name`` in ``stage_s``."""
        with self._lock:
            self.stage_s[name] = max(self.stage_s.get(name, value), value)

    def record(self, name: str, start: float, end: float, thread: str,
               **attrs) -> int:
        """Add a span timed elsewhere on the same clock (the engine's
        per-batch records), with no parent; returns its index. It adds to
        no total."""
        with self._lock:
            self.spans.append({"name": name, "start": start, "end": end,
                               "thread": thread, "parent": None,
                               "job": self.job, "args": attrs})
            return len(self.spans) - 1

    @contextlib.contextmanager
    def active(self):
        """Make this the tracer that ``current()`` returns."""
        global _current
        prev, _current = _current, self
        try:
            yield self
        finally:
            _current = prev

    def total(self) -> float:
        return time.perf_counter() - self._t0


class _NoTracer:
    """The tracer where no job has set one: records nothing."""

    spans: tuple = ()

    def stage(self, name: str):
        return contextlib.nullcontext()

    def last(self) -> dict:
        return _NO_SPAN

    def note(self, **attrs) -> None:
        pass

    def add(self, name: str, value: float) -> None:
        pass

    def peak(self, name: str, value: float) -> None:
        pass


_NO_SPAN = {"start": 0.0, "end": 0.0}
NO_TRACER = _NoTracer()
_current: StageTimer | None = None


def current() -> StageTimer | _NoTracer:
    """The running job's tracer, or one that records nothing."""
    return _current or NO_TRACER


def chrome_trace(spans: list[dict]) -> dict:
    """``spans`` as Chrome trace JSON: complete events (``ph`` "X") with
    ``ts`` and ``dur`` in microseconds of ``CLOCK_MONOTONIC``, a ``tid``
    per thread name (named by ``thread_name`` metadata events), and each
    span's attributes, job, index and parent index as ``args``."""
    pid = os.getpid()
    tids: dict[str, int] = {}
    events = []
    for i, s in enumerate(spans):
        if s["end"] is None:
            continue
        tid = tids.setdefault(s["thread"], len(tids) + 1)
        args = dict(s["args"], job=s["job"], span=i, parent=s["parent"])
        events.append({"name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                       "ts": s["start"] * 1e6,
                       "dur": (s["end"] - s["start"]) * 1e6, "args": args})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
             "args": {"name": n}} for n, t in tids.items()]
    return {"clock": CLOCK, "displayTimeUnit": "ms",
            "traceEvents": meta + events}


def write_chrome_trace(path: str, spans: list[dict]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f)


@dataclasses.dataclass
class FunnelStats:
    """Candidate funnel counters — the CountStats analog.

    Tracks how many candidate (window, read) pairs survive each filter so
    ratio regressions can be localized (sketch recall vs aligner acceptance).
    """

    minhash_hits: int = 0        # pairs passing the sketch-collision threshold
    not_claimed: int = 0         # of those, reads not yet claimed by a contig
    aligned_ok: int = 0          # of those, accepted by the aligner
    repetitive: int = 0          # reads excluded by the self-similarity screen
    capped_buckets: int = 0      # sketch buckets dropped by the size cap
    capped_reads: int = 0        # reads touched by a dropped bucket
    reads_in_contigs: int = 0
    lone_reads: int = 0
    contigs: int = 0

    def merge(self, other: "FunnelStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def report(self) -> str:
        return (
            f"funnel: minhash={self.minhash_hits} unclaimed={self.not_claimed} "
            f"aligned={self.aligned_ok} repetitive={self.repetitive} "
            f"capped_buckets={self.capped_buckets} | "
            f"contigs={self.contigs} in_contigs={self.reads_in_contigs} "
            f"lone={self.lone_reads}"
        )
