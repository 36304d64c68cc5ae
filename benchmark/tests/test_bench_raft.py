"""The motion-compensated edit cell's own pieces on the CPU: RAFT's work
reckoner against ``FlopCounterMode`` over the reference, the new readers
on a canned window, the driver's span sums, a whole tiny run past the
look for a chip (a planted fault in RAFT's lookup is not correct, the
control fails a limit), and a program without RAFT's pair counter failing
the set-up at once. The cell's files are held by ``test_bench_files.py``."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

import tiny_flow  # noqa: I001  (puts benchmark/ on the path)
import run
from faults_flow import lookup_swap
from harness import PEAK_BYTES, Readings, benchmark_spec, metric_reader
from reference import raft as rr
from work.raft import PEAK_TF32_FLOPS, raft_pair

SPEC = benchmark_spec()
CELL = tiny_flow.EDIT_FLOW


@pytest.mark.parametrize("size,tiny", [((32, 48), True), ((64, 64), False), ((384, 384), False)])
def test_work_counts_the_references_products(size, tiny):
    """Operations equal FlopCounterMode's count of one pair through the
    reference on the meta device; bytes bound RAFT-large at 384 x 384
    beside its operations (0.43 ms each at the peaks)."""
    from torch.utils.flop_counter import FlopCounterMode

    from insv2v_torch.models.raft import RAFT, RaftConfig

    cfg = RaftConfig.tiny() if tiny else RaftConfig()
    with torch.device("meta"):
        model = RAFT(cfg)
    W = {k: torch.empty(v.shape, device="meta") for k, v in model.state_dict().items()}
    im = torch.empty((1,) + size + (3,), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        rr.raft_pairs(W, {"corr_levels": cfg.corr_levels, "corr_radius": cfg.corr_radius,
                          "iters": cfg.iters}, im, im)
    flops, nbytes = raft_pair(*size, **dataclasses.asdict(cfg))
    assert flops == counter.get_total_flops()
    if size == (384, 384):
        assert flops == pytest.approx(212.85e9, rel=1e-3)
        assert 0.8 < (nbytes / PEAK_BYTES) / (flops / PEAK_TF32_FLOPS) < 1.2


def readings(**kw) -> Readings:
    work = (PEAK_TF32_FLOPS * 1e-3, PEAK_BYTES * 0.5e-3)  # 1 ms of operations, 0.5 of bytes
    r = Readings(CELL, units=2, counts={"unet_steps": 120, "raft_pairs": 192, "raft_calls": 12},
                 spans={"window": 6.0, "raft": 2.4, "raft_lookup": 0.6},
                 work={"raft": [work]})
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_readers_on_a_canned_window():
    r = readings()
    assert metric_reader("raft_ms_per_pair.edit_flow").read(r) == pytest.approx(12.5)
    assert metric_reader("raft_lookup_ms.edit_flow").read(r) == pytest.approx(50.0)
    assert metric_reader("raft_roofline.edit_flow").read(r) == pytest.approx(100 * 0.192 / 2.4)
    assert metric_reader("unet_step_ms.edit_flow").read(r) == pytest.approx(50.0)
    for name in ("raft_ms_per_pair", "raft_lookup_ms", "raft_roofline"):
        assert metric_reader(name + ".edit_flow").read(readings(counts={}, spans={})) is None


def _rec(name, unit, dev, profiled=False):
    return types.SimpleNamespace(name=name, unit=unit, profiled=profiled, failed=False,
                                 dev_start_ns=None if dev is None else 0,
                                 dev_end_ns=None if dev is None else int(dev * 1e6))


def test_span_sums_keep_to_the_windows_edits():
    drv = tiny_flow.Cell.load(CELL).driver()
    snap = {"spans": {"flow.raft": [_rec("flow.raft", 1, None), _rec("flow.raft", 2, 3.0),
                                    _rec("flow.raft", 2, 4.0), _rec("flow.raft", 3, 5.0)]}}
    assert drv.span_device_s(snap, "flow.raft", {2, 3}) == (pytest.approx(0.012), 3)
    assert drv.span_device_s(snap, "raft.lookup", {2}) == (0.0, 0)
    snap["spans"]["flow.raft"].append(_rec("flow.raft", 3, 1.0, profiled=True))
    assert drv.span_device_s(snap, "flow.raft", {2, 3}) == (0.0, 0)


def test_a_planted_lookup_swap_is_not_correct(monkeypatch):
    owner, name, broken = lookup_swap()
    monkeypatch.setattr(owner, name, broken)
    result = run.run_cell(SPEC, tiny_flow.tiny_flow_cell("bfloat16"), 2 ** 31 + 29, 0.0, False,
                          device="cpu")
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["flow"]["value"] > result["checks"]["flow"]["limit"]


def test_the_control_fails():
    cell = tiny_flow.tiny_flow_cell("bfloat16")
    drv = cell.driver().Driver(cell, 2 ** 31 + 31, "cpu")
    drv.setup()
    drv.run_unit(0)
    drv.release()
    prog, ctrl = drv.check(control=True)
    limits = cell.spec["limits"]
    assert set(ctrl) == set(prog) == set(limits)
    assert ctrl["flow"] > limits["flow"] and ctrl["flow"] > prog["flow"]
    assert any(ctrl[k] > limits[k] for k in limits), (ctrl, limits)


def test_a_program_without_the_pair_counter_fails_at_once(monkeypatch):
    from insv2v_torch.utils import tracing

    snapshot = tracing.snapshot
    monkeypatch.setattr(tracing, "snapshot", lambda: {k: v for k, v in snapshot().items()
                                                      if k != "counters"})
    cell = tiny_flow.tiny_flow_cell()
    with pytest.raises(SystemExit, match="RAFT pairs"):
        cell.driver().Driver(cell, 1, "cpu").setup()
