"""The readers of the program's spans on a canned tracer snapshot: the
per-microbatch and per-step medians, the per-step sum of the update's
parts, records and units the profiler ran over (or an exception closed)
left out, leads from device intervals only, and None where a name has no
record or the program no tracer."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts benchmark/ on the path)
from harness import metric_reader

MS = 1_000_000  # ns


def rec(name, unit, ms, profiled=False, failed=False, lead=None, start=0):
    dev = None if lead is None else start + int(lead * MS)
    return SimpleNamespace(name=name, unit=unit, start_ns=start, end_ns=start + int(ms * MS),
                           profiled=profiled, failed=failed, dev_start_ns=dev,
                           dev_end_ns=None if dev is None else dev + MS)


def train_snapshot():
    """Steps 0-3 of two microbatches each: step 0 slow (the cold first
    step), step 3 under the profiler."""
    spans = {}
    add = lambda r: spans.setdefault(r.name, []).append(r)
    for step, scale in ((0, 10.0), (1, 1.0), (2, 2.0), (3, 100.0)):
        prof = step == 3
        for _ in range(2):
            add(rec("train.encode", step, 1 * scale, profiled=prof))
            add(rec("train.forward", step, 3 * scale, profiled=prof))
            add(rec("train.backward", step, 5 * scale, profiled=prof))
            add(rec("train.accumulate", step, 0.5 * scale, profiled=prof))
        add(rec("train.optimizer", step, 2 * scale, profiled=prof))
        add(rec("train.push_params", step, 1 * scale, profiled=prof))
        add(rec("train.loss_sync", step, 4 * scale, profiled=prof))
    for batch, ms in enumerate((30.0, 10.0, 20.0, 40.0, 999.0)):
        add(rec("loader.produce", batch, ms, profiled=batch == 4))
    return {"spans": spans, "counts": {k: len(v) for k, v in spans.items()}, "launches": {}}


def read(name, snap):
    return metric_reader(name).value(snap)


def test_train_readers_take_medians_over_unprofiled_steps():
    snap = train_snapshot()
    # steps 0, 1, 2 (step 3 left out whole: one of its records is profiled)
    assert read("dispatch_ms.forward.train", snap) == pytest.approx(4 * 2.0)
    assert read("dispatch_ms.backward.train", snap) == pytest.approx(5 * 2.0)
    # the update: both microbatches' accumulates, optimizer and copy
    assert read("dispatch_ms.update.train", snap) == pytest.approx((2 * 0.5 + 2 + 1) * 2.0)
    assert read("sync_wait_ms.train", snap) == pytest.approx(4 * 2.0)
    assert read("loader_busy_ms.train", snap) == pytest.approx(25.0)


def test_one_left_out_record_drops_its_unit():
    snap = train_snapshot()
    snap["spans"]["train.encode"][4].profiled = True  # step 2's first encode
    # steps 0 and 1 remain: 40 and 4 ms a microbatch
    assert read("dispatch_ms.forward.train", snap) == pytest.approx(22.0)
    assert read("dispatch_ms.backward.train", snap) == pytest.approx(10.0)  # not read there
    snap["spans"]["train.backward"][2].failed = True  # step 1's first backward
    # steps 0 and 2 remain: 50 and 10 ms a microbatch
    assert read("dispatch_ms.backward.train", snap) == pytest.approx(30.0)


def test_gif_and_lead_readers():
    snap = {"spans": {
        "media.save_gif": [rec("media.save_gif", 1, ms) for ms in (2500.0, 2700.0, 2600.0)],
        "sampler.step": ([rec("sampler.step", 1, 90.0) for _ in range(3)]  # no device tier
                         + [rec("sampler.step", 2, 90.0, lead=ld) for ld in (0.2, 40.0, 60.0)]
                         + [rec("sampler.step", 3, 90.0, lead=500.0, profiled=True)])}}
    assert read("gif_write_s.datagen", snap) == pytest.approx(2.6)
    assert read("host_lead_ms.edit", snap) == pytest.approx(40.0)
    assert read("host_lead_ms.datagen", snap) == pytest.approx(40.0)


@pytest.mark.parametrize("name", ["dispatch_ms.forward.train", "dispatch_ms.backward.train",
                                  "dispatch_ms.update.train", "sync_wait_ms.train",
                                  "loader_busy_ms.train", "gif_write_s.datagen",
                                  "host_lead_ms.edit", "host_lead_ms.datagen"])
def test_nothing_to_read_reads_none(name):
    mod = metric_reader(name)
    assert mod.value(None) is None  # a program without the tracer
    assert mod.value({"spans": {}, "counts": {}, "launches": {}}) is None
    assert (mod.UNIT, mod.SOURCE) in {("ms", "program_span"), ("s", "program_span")}
    # leads exist only with a device interval
    only_host = {"spans": {"sampler.step": [rec("sampler.step", 1, 5.0)]}}
    if name.startswith("host_lead"):
        assert mod.value(only_host) is None
