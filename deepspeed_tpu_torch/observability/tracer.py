"""Request-scoped distributed tracing for the serving stack (counterpart
of ``deepspeed_tpu/observability/tracer.py``: the same spans, event names
and fields; device annotations on ``torch.profiler.record_function``).

The reference ships a ``profiling/`` layer plus a comms logger; this is
the serving equivalent: one low-overhead host-side :class:`Tracer`
whose spans thread a ``trace_id`` through every hop a request takes —
scheduler ticks, replica incarnations (kill → replay), rolling-restart
migrations, and disaggregated prefill→decode KV handoffs — and export as
Chrome/Perfetto trace-event JSON so one request's life is ONE connected
timeline however many processes served it.

Design constraints (the decode fast tick must stay <2% slower traced):

* **ring buffer** — spans land in a fixed-capacity ring; a long-running
  replica never grows host memory per span, and the most recent window
  doubles as the crash flight recorder's evidence (the JAX package's
  ``observability/flight_recorder.py``, not ported);
* **no locks on the hot path** — record construction + a single
  list-slot store per span, both atomic under the GIL; the only
  synchronisation is at export time (a snapshot copy);
* **monotonic clock** — ``time.monotonic_ns``; wall-clock anchoring
  happens once per tracer so merged multi-process traces line up;
* **id hygiene across incarnations** — span ids carry a per-tracer
  random prefix, so two incarnations of a replica (fresh Tracer each)
  can contribute spans to the SAME ``trace_id`` without id collisions.

Host↔device alignment: :func:`annotate` wraps engine dispatch sites in
``torch.profiler.record_function`` so a ``torch.profiler`` capture lines
the CUDA kernel timeline up against these host spans.  It returns a shared no-op
context unless :func:`enable_device_annotations` (or ``DS_DEVICE_TRACE``)
turned annotations on — the steady-state tick pays nothing by default.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence


def mint_trace_id() -> str:
    """A 16-hex-char globally unique trace id (one per user request,
    minted at submit and carried across every replica incarnation)."""
    return os.urandom(8).hex()


# --------------------------------------------------------------------- #
# Device-side annotations (host↔device trace alignment)
# --------------------------------------------------------------------- #
_NULL_CM = contextlib.nullcontext()
_DEVICE_ANNOTATIONS = os.environ.get("DS_DEVICE_TRACE", "") not in ("", "0")


def enable_device_annotations(on: bool = True) -> None:
    """Turn :func:`annotate` into real ``torch.profiler.record_function``
    brackets (named slices on the profiler's host track, aligned with
    the CUDA kernel timeline when a ``torch.profiler`` capture is
    active)."""
    global _DEVICE_ANNOTATIONS
    _DEVICE_ANNOTATIONS = bool(on)


def device_annotations_enabled() -> bool:
    return _DEVICE_ANNOTATIONS


def annotate(name: str):
    """Context manager bracketing a device dispatch for the profiler.
    A shared no-op unless annotations were enabled — the decode fast
    tick must not pay a record_function allocation per step by default."""
    if not _DEVICE_ANNOTATIONS:
        return _NULL_CM
    from torch.profiler import record_function

    return record_function(name)


def step_annotation(step: int):
    """A ``ds_tick#<step>`` slice for one scheduler tick / train step —
    groups the tick's device work under a step marker in the profiler
    timeline (JAX: ``StepTraceAnnotation("ds_tick", step_num=step)``).
    Same no-op contract as :func:`annotate`."""
    if not _DEVICE_ANNOTATIONS:
        return _NULL_CM
    from torch.profiler import record_function

    return record_function(f"ds_tick#{step}")


# --------------------------------------------------------------------- #
# Spans
# --------------------------------------------------------------------- #
class SpanHandle:
    """An OPEN span.  Close it with :meth:`Tracer.finish` (or use the
    :meth:`Tracer.span` context manager).  Cheap on purpose."""

    __slots__ = ("name", "tid", "trace_id", "span_id", "parent",
                 "t0_ns", "attrs")

    def __init__(self, name, tid, trace_id, span_id, parent, t0_ns, attrs):
        self.name = name
        self.tid = tid
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent = parent
        self.t0_ns = t0_ns
        self.attrs = attrs


class Tracer:
    """Bounded-ring span recorder; see module doc.

    ``enabled=False`` makes every record call a cheap early return — the
    handles still mint ids so trace continuity survives a disable/enable
    window (e.g. a bench's untraced A arm).
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 tid: str = "main"):
        if capacity < 1:
            raise ValueError("Tracer capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self.default_tid = tid
        #: per-tracer random prefix keeps span ids unique when several
        #: tracers (replica incarnations, processes) feed one trace
        self._sid_prefix = os.urandom(4).hex()
        self._sid_counter = itertools.count(1)
        #: the ring: fixed-size slot store, monotone write index
        self._ring: List[Optional[dict]] = [None] * capacity
        self._n = 0                         # total records ever written
        #: open spans by span_id (closed ones move to the ring)
        self._open: Dict[str, SpanHandle] = {}
        #: wall-clock anchor: wall seconds at monotonic t0 — lets a
        #: merged multi-process trace share one absolute axis
        self._mono0_ns = time.monotonic_ns()
        self._wall0_s = time.time()
        self.dropped = 0                    # ring overwrites (telemetry)

    # -- recording ------------------------------------------------------ #
    def _mint_span_id(self) -> str:
        return f"{self._sid_prefix}{next(self._sid_counter):x}"

    def start(self, name: str, *, trace_id: Optional[str] = None,
              parent: Optional[str] = None, tid: Optional[str] = None,
              attrs: Optional[dict] = None) -> SpanHandle:
        """Open a span; returns its handle (``handle.span_id`` is the
        parent id for children)."""
        h = SpanHandle(name, tid or self.default_tid, trace_id,
                       self._mint_span_id(), parent,
                       time.monotonic_ns(), attrs)
        if self.enabled:
            self._open[h.span_id] = h
        return h

    def finish(self, h: SpanHandle,
               attrs: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._open.pop(h.span_id, None)
        a = h.attrs
        if attrs:
            a = {**(a or {}), **attrs}
        self._append({
            "name": h.name, "ph": "X", "tid": h.tid,
            "trace_id": h.trace_id, "span_id": h.span_id,
            "parent": h.parent, "t0_ns": h.t0_ns,
            "t1_ns": time.monotonic_ns(),
            **({"attrs": a} if a else {})})

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id: Optional[str] = None,
             parent: Optional[str] = None, tid: Optional[str] = None,
             attrs: Optional[dict] = None):
        h = self.start(name, trace_id=trace_id, parent=parent, tid=tid,
                       attrs=attrs)
        try:
            yield h
        finally:
            self.finish(h)

    def instant(self, name: str, *, trace_id: Optional[str] = None,
                parent: Optional[str] = None, tid: Optional[str] = None,
                attrs: Optional[dict] = None) -> None:
        """A zero-duration event (submit, preempt, conviction...)."""
        if not self.enabled:
            return
        self._append({
            "name": name, "ph": "i", "tid": tid or self.default_tid,
            "trace_id": trace_id, "span_id": self._mint_span_id(),
            "parent": parent, "t0_ns": time.monotonic_ns(),
            **({"attrs": attrs} if attrs else {})})

    def _append(self, rec: dict) -> None:
        i = self._n
        if i >= self.capacity and self._ring[i % self.capacity] is not None:
            self.dropped += 1
        self._ring[i % self.capacity] = rec
        self._n = i + 1

    # -- reading -------------------------------------------------------- #
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def records(self, tail: Optional[int] = None) -> List[dict]:
        """Ring contents oldest→newest (a snapshot copy), optionally only
        the most recent ``tail`` records."""
        n = self._n
        if n <= self.capacity:
            out = [r for r in self._ring[:n]]
        else:
            cut = n % self.capacity
            out = self._ring[cut:] + self._ring[:cut]
        out = [r for r in out if r is not None]
        if tail is not None:
            out = out[-tail:]
        return out

    def open_spans(self) -> List[SpanHandle]:
        return list(self._open.values())

    def telemetry(self) -> Dict[str, float]:
        """``observability/*`` ring-health scalars — the registry
        provider form of :attr:`dropped` (a wrapped ring used to be
        silent: records vanished and nothing counted them)."""
        return {
            "observability/dropped_spans": float(self.dropped),
            "observability/spans_recorded": float(self._n),
            "observability/spans_open": float(len(self._open)),
        }

    def clear(self) -> None:
        self._ring = [None] * self.capacity
        self._n = 0
        self._open.clear()
        self.dropped = 0

    # -- export --------------------------------------------------------- #
    def _ts_us(self, t_ns: int) -> float:
        """Monotonic ns → wall-anchored µs (the trace-event ts unit)."""
        return (self._wall0_s * 1e6
                + (t_ns - self._mono0_ns) / 1e3)

    def export_events(self, tail: Optional[int] = None,
                      tid: Optional[str] = None,
                      include_open: bool = True) -> List[dict]:
        """Chrome trace-event dicts ("X" complete spans + "i" instants).
        Still-open spans export with ``args.unfinished`` (a replica died
        mid-span; the evidence must not vanish with it).  A ring that
        wrapped leads with a ``tracer/dropped_spans`` metadata event so
        a reader knows the timeline's head was overwritten, not quiet."""
        now_ns = time.monotonic_ns()
        recs = self.records(tail)
        if include_open:
            recs = recs + [{
                "name": h.name, "ph": "X", "tid": h.tid,
                "trace_id": h.trace_id, "span_id": h.span_id,
                "parent": h.parent, "t0_ns": h.t0_ns, "t1_ns": now_ns,
                "attrs": {**(h.attrs or {}), "unfinished": True},
            } for h in self._open.values()]
        out = []
        if self.dropped:
            # truncation is part of the record: phase "M" so schema
            # validators treat it as metadata, not an anonymous span
            out.append({
                "name": "tracer/dropped_spans", "ph": "M",
                "ts": self._ts_us(self._mono0_ns), "pid": os.getpid(),
                "tid": tid if tid is not None else self.default_tid,
                "args": {"dropped_spans": self.dropped,
                         "capacity": self.capacity,
                         "recorded": self._n}})
        for r in recs:
            if tid is not None and r["tid"] != tid:
                continue
            args: Dict[str, Any] = {"trace_id": r["trace_id"],
                                    "span_id": r["span_id"],
                                    "parent": r["parent"]}
            args.update(r.get("attrs") or {})
            ev = {"name": r["name"], "ph": r["ph"],
                  "ts": self._ts_us(r["t0_ns"]),
                  "pid": os.getpid(), "tid": r["tid"], "args": args}
            if r["ph"] == "X":
                ev["dur"] = max((r["t1_ns"] - r["t0_ns"]) / 1e3, 0.0)
            else:
                ev["s"] = "t"              # instant scope: thread
            out.append(ev)
        return out


# --------------------------------------------------------------------- #
# Trace files
# --------------------------------------------------------------------- #
def merge_events(*event_lists: Iterable[dict]) -> List[dict]:
    """Merge per-tracer/per-process event lists into one timeline,
    sorted by ts (ties by name for determinism)."""
    out: List[dict] = []
    for evs in event_lists:
        out.extend(evs)
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("name", "")))
    return out


def _tid_metadata(events: Sequence[dict]) -> List[dict]:
    """Perfetto wants integer tids; emit thread_name metadata mapping
    our string tids onto stable small ints."""
    labels: Dict[tuple, int] = {}
    for e in events:
        key = (e.get("pid", 0), e.get("tid", "main"))
        if key not in labels:
            labels[key] = len(labels)
    meta = [{"name": "thread_name", "ph": "M", "pid": pid,
             "tid": idx, "args": {"name": str(tid)}}
            for (pid, tid), idx in labels.items()]
    return meta


def write_chrome_trace(path: str, events: Sequence[dict]) -> str:
    """Write a Chrome/Perfetto-loadable trace-event JSON file (atomic:
    tmp + rename; parent dirs created)."""
    labels: Dict[tuple, int] = {}
    meta = _tid_metadata(events)
    for m in meta:
        labels[(m["pid"], m["args"]["name"])] = m["tid"]
    norm = []
    for e in events:
        e = dict(e)
        e["tid"] = labels[(e.get("pid", 0), str(e.get("tid", "main")))]
        norm.append(e)
    payload = {"traceEvents": meta + norm, "displayTimeUnit": "ms"}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def load_chrome_trace(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return list(data.get("traceEvents", []))
    return list(data)
