"""One tracer for the port: named spans on the host's monotonic clock,
always on, and CUDA-event device intervals on the same clock inside a
call whose caller asked for ``timings``.

Host tier. ``with span("train.forward"):`` reads ``time.perf_counter_ns``
at both ends and writes one record into a ring kept for its name (the
newest ``CAPACITY`` records; the oldest is overwritten). A record (a
``Span``) holds the name, an id, the parent (the enclosing span on the
same thread), the unit, the thread, the host start and end in ns, whether
the torch profiler was running at either end, and whether an exception
closed it. The unit is the trainer's step, or a call counter for each
edit or pair: the spans of one unit share it. A span given ``unit=``
sets it for the spans it encloses on its thread. This tier does no device
work: no synchronisation and no CUDA event.

Device tier. ``StageClock(device, timings)`` is the stage clock of the
editor, the samplers and the data generator. With ``timings`` None it only
opens a unit. With a dict it synchronises the device at its start and at
each ``mark(stage)``, which closes the span ``stage.<stage>`` and writes
its wall seconds into ``timings[stage]``. On a CUDA device it also
records, for every span opened on its thread until it closes, a CUDA event
at the span's start and end on the current stream. One anchor pair puts
the events on the host's clock: an event recorded before the clock's
first synchronisation and the host time read after it, so that an
event's time is ``anchor_ns + anchor.elapsed_time(event)``. The anchor
has completed when the host time is read, so a mapped device time is
late by at most the synchronisation's wake-up and never early: a span's
lead (device start minus host start) is never under its true value. The
events are resolved when the clock closes, after its last mark. A clock
nested in another on the same thread shares its unit and its events.

``snapshot()`` is what a reader sees: each name's records, oldest first,
each name's count of spans, the launch counters of the six kernel
wrappers (their ``.launches``) and the program's work counters
(``raft.pairs``: the (query, ref) pairs RAFT has run, ``RAFT.pairs``).

No ``record_function`` and no NVTX range: torch's profiler keeps such a
range as a device event on its timeline, where it would count as
device-busy time in a trace of the same stretch.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["CAPACITY", "Span", "StageClock", "span", "snapshot", "records", "count", "unit_ms",
           "clear", "kernel_wrappers"]

CAPACITY = 4096  # records kept a name

_now = time.perf_counter_ns
_span_ids = itertools.count(1)
_unit_ids = itertools.count(1)


def _profiler_flag():
    """A cheap read of whether the torch profiler is running (a flag the
    profiler sets for every thread where torch has one)."""
    from torch.autograd import profiler

    if hasattr(profiler, "_is_profiler_enabled"):
        return lambda: profiler._is_profiler_enabled
    return torch._C._autograd._profiler_enabled


_profiling = _profiler_flag()


class _Thread(threading.local):
    """A thread's open spans, its unit and its device tier."""

    def __init__(self):
        self.stack: List[Span] = []
        self.unit = None
        self.tier: Optional[_DeviceTier] = None


_local = _Thread()


class _Ring:
    __slots__ = ("slots", "count", "lock")

    def __init__(self):
        self.slots: List[Optional[Span]] = [None] * CAPACITY
        self.count = 0
        self.lock = threading.Lock()

    def put(self, rec: "Span") -> None:
        with self.lock:
            self.slots[self.count % CAPACITY] = rec
            self.count += 1

    def records(self) -> List["Span"]:
        """Oldest first."""
        with self.lock:
            n, slots = self.count, list(self.slots)
        if n <= CAPACITY:
            return slots[:n]
        i = n % CAPACITY
        return slots[i:] + slots[:i]


_rings: Dict[str, _Ring] = {}
_rings_lock = threading.Lock()


def _ring(name: str) -> _Ring:
    ring = _rings.get(name)
    if ring is None:
        with _rings_lock:
            ring = _rings.setdefault(name, _Ring())
    return ring


class _DeviceTier:
    """The CUDA events of one top-level stage clock's spans, and its anchor."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pending: List[tuple] = []  # (span, start event, end event)
        self.anchor = self.event()
        self.anchor_ns = 0  # the host time after the clock's first synchronisation

    def event(self) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def resolve(self) -> None:
        torch.cuda.synchronize(self.device)
        at = lambda ev: self.anchor_ns + round(self.anchor.elapsed_time(ev) * 1e6)
        for rec, start, end in self.pending:
            rec.dev_start_ns, rec.dev_end_ns = at(start), at(end)
        self.pending.clear()


class Span:
    """One span, used as ``with span(name):``; once closed, its own record."""

    __slots__ = ("name", "id", "parent", "unit", "thread", "start_ns", "end_ns", "profiled",
                 "failed", "dev_start_ns", "dev_end_ns", "_outer_unit", "_start_event")

    def __init__(self, name: str, unit=None):
        self.name, self.unit = name, unit
        self.parent = None
        self.failed = False
        self.dev_start_ns = self.dev_end_ns = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        return None if self.dev_start_ns is None else (self.dev_end_ns - self.dev_start_ns) / 1e6

    @property
    def lead_ms(self) -> Optional[float]:
        """Device start minus host start: how far the device ran behind."""
        return None if self.dev_start_ns is None else (self.dev_start_ns - self.start_ns) / 1e6

    def __enter__(self) -> "Span":
        local = _local
        stack = local.stack
        if stack:
            self.parent = stack[-1].id
        self._outer_unit = local.unit
        if self.unit is None:
            self.unit = local.unit
        else:
            local.unit = self.unit
        self.id = next(_span_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        self.profiled = _profiling()
        tier = local.tier
        self.start_ns = _now()
        self._start_event = None if tier is None else (tier, tier.event())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        local = _local
        started = self._start_event
        if started is not None:
            tier, ev = started
            if tier is local.tier:
                tier.pending.append((self, ev, tier.event()))
            self._start_event = None
        self.end_ns = _now()
        self.profiled = self.profiled or _profiling()
        self.failed = exc_type is not None
        stack = local.stack
        while stack and stack.pop() is not self:
            pass
        local.unit = self._outer_unit
        _ring(self.name).put(self)
        return False


span = Span


class StageClock:
    """The synchronised wall seconds of a call's stages into ``timings``
    (see the module's docstring); a context manager around the call."""

    def __init__(self, device, timings: Optional[dict]):
        self.device, self.timings = torch.device(device), timings
        self._tier: Optional[_DeviceTier] = None
        self.t = self.t0 = 0

    def _sync_now(self) -> int:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return _now()

    def __enter__(self) -> "StageClock":
        local = _local
        self._outer_unit = local.unit
        if local.unit is None:
            local.unit = next(_unit_ids)
        if self.timings is not None:
            if self.device.type == "cuda" and local.tier is None:
                local.tier = self._tier = _DeviceTier(self.device)
            self.t = self.t0 = self._sync_now()
            if self._tier is not None:
                self._tier.anchor_ns = self.t
        return self

    def mark(self, stage: str) -> None:
        """Close the stage that began at the last mark (or the start)."""
        if self.timings is None:
            return
        t = self._sync_now()
        local = _local
        rec = Span("stage." + stage, local.unit)
        rec.id, rec.thread = next(_span_ids), threading.get_ident()
        if local.stack:
            rec.parent = local.stack[-1].id
        rec.start_ns, rec.end_ns, rec.profiled = self.t, t, _profiling()
        _ring(rec.name).put(rec)
        self.timings[stage] = (t - self.t) / 1e9
        self.t = t

    @property
    def total(self) -> float:
        """Seconds from the clock's start to its last mark."""
        return (self.t - self.t0) / 1e9

    def __exit__(self, exc_type, exc, tb) -> bool:
        local = _local
        local.unit = self._outer_unit
        tier, self._tier = self._tier, None
        if tier is not None:
            local.tier = None
            if exc_type is None:
                tier.resolve()
        return False


# --- reading ---------------------------------------------------------------

def records(name: str) -> List[Span]:
    """``name``'s records in the ring, oldest first."""
    ring = _rings.get(name)
    return ring.records() if ring is not None else []


def count(name: str) -> int:
    """How many ``name`` spans have closed, overwritten records included."""
    ring = _rings.get(name)
    return ring.count if ring is not None else 0


def unit_ms(name: str, unit) -> float:
    """Host ms of ``name``'s newest run of records in ``unit``, summed."""
    total, seen = 0, False
    for rec in reversed(records(name)):
        if rec.unit == unit:
            total += rec.end_ns - rec.start_ns
            seen = True
        elif seen:
            break
    return total / 1e6


def kernel_wrappers() -> tuple:
    """The six kernel wrappers whose ``.launches`` count their launches."""
    from insv2v_torch.ops import attention, fused_ff, fused_norm

    return (attention.flash_attention, attention.flash_attention_headfold,
            fused_ff.fused_geglu_ff, attention.temporal_attention, fused_norm.fused_layer_norm,
            fused_norm.fused_group_norm)


def _launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters."""
    return {f.__name__: f.launches for f in kernel_wrappers()}


def _counters() -> Dict[str, int]:
    """The program's work counters."""
    from insv2v_torch.models.raft import RAFT

    return {"raft.pairs": RAFT.pairs}


def snapshot() -> dict:
    """{"spans": {name: records oldest first}, "counts": {name: spans
    recorded}, "launches": {wrapper: launches}, "counters": {name: count}}."""
    with _rings_lock:
        rings = dict(_rings)
    return {"spans": {n: r.records() for n, r in rings.items()},
            "counts": {n: r.count for n, r in rings.items()},
            "launches": _launches(), "counters": _counters()}


def clear() -> None:
    """Drop every record (the counts with them)."""
    with _rings_lock:
        _rings.clear()
