"""What the readers of the program's own spans share: the records of the
port's tracer (``insv2v_torch/utils/tracing.py``) over the whole run
(set-up's checked steps and warm-up, the window, the profiled stretch),
those the torch profiler ran over or an exception closed left out, and
the median over the run's units or records. A program without the
tracer, or without a record of the names read, reads nothing (None)."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional, Sequence


def snapshot() -> Optional[dict]:
    """The tracer's snapshot, or None where the program has no tracer."""
    try:
        from insv2v_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def _records(snap: Optional[dict], name: str) -> list:
    return [] if snap is None else snap["spans"].get(name, [])


def _kept(r) -> bool:
    return not (r.profiled or r.failed)


def per_unit_ms(snap: Optional[dict], names: Sequence[str],
                per: Optional[str] = None) -> Optional[float]:
    """The median over units of the host ms of ``names``' records summed
    in a unit, over the count of ``per``'s records in it where ``per`` is
    given (ms a microbatch, say). A unit that holds a record the profiler
    ran over, or one an exception closed, is left out whole."""
    ms: Dict[object, float] = {}
    count: Dict[object, int] = {}
    dropped = set()
    for name in names:
        for r in _records(snap, name):
            if not _kept(r):
                dropped.add(r.unit)
            ms[r.unit] = ms.get(r.unit, 0.0) + (r.end_ns - r.start_ns) / 1e6
            if name == per:
                count[r.unit] = count.get(r.unit, 0) + 1
    if per is None:
        values = [v for u, v in ms.items() if u not in dropped]
    else:
        values = [v / count[u] for u, v in ms.items() if u not in dropped and count.get(u)]
    return statistics.median(values) if values else None


def per_record(snap: Optional[dict], name: str, value: Callable) -> Optional[float]:
    """The median of ``value(record)`` over ``name``'s kept records where
    it is not None."""
    values = [value(r) for r in _records(snap, name) if _kept(r)]
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def host_ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def lead_ms(r) -> Optional[float]:
    """Device start minus host start, where the span has a device interval
    (the editor's or sampler's ``timings`` were asked for)."""
    return None if r.dev_start_ns is None else (r.dev_start_ns - r.start_ns) / 1e6
