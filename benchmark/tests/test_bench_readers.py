"""The per-layer readers on a canned stretch: busy time as the union of
intervals, the idle share and the gaps by host op, the class times, the
rooflines against the work, and the launch-count cross-check that fails
when the profiler dropped a record."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401
from harness import PEAK_BF16_FLOPS, PEAK_BYTES, DroppedRecords, Readings, Trace, metric_reader

# microseconds: two flash launches, one FF launch (its gate and out
# kernels), a copy overlapping the second flash, an elementwise kernel
DEVICE = [("flash_fwd64_kernel<false>", 0.0, 100.0), ("ff_gate_res_kernel<320>", 150.0, 250.0),
          ("ff_out_kernel", 250.0, 300.0), ("flash_fwd_kernel<40,false,2,false>", 400.0, 500.0),
          ("Memcpy DtoD (Device -> Device)", 450.0, 520.0),
          ("void at::native::vectorized_elementwise_kernel<4, add>", 600.0, 650.0)]
HOST = [("aten::conv2d", 90.0, 160.0), ("aten::copy_", 300.0, 420.0),
        ("cudaLaunchKernel", 310.0, 330.0), ("python outer", 0.0, 700.0)]
FLASH_WORK = [(PEAK_BF16_FLOPS * 50e-6, 1.0), (1.0, PEAK_BYTES * 20e-6)]  # 50 us, 20 us least
FF_WORK = [(PEAK_BF16_FLOPS * 75e-6, 1.0)]


def readings(**kw) -> Readings:
    r = Readings("cell", units=2, window_s=4.0, flops_per_unit=PEAK_BF16_FLOPS, peak_bytes=2 ** 31,
                 spans={"text": 0.5, "vae_encode": 1.0, "vae_decode": 0.5, "window": 3.0},
                 counts={"unet_steps": 300}, trace=Trace(list(DEVICE), sorted(HOST, key=lambda h: h[1])),
                 stretch_calls=2, launches={"flash_attention": 2, "fused_geglu_ff": 1},
                 work={"flash": list(FLASH_WORK), "ff": list(FF_WORK)})
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_busy_union_idle_share_and_gaps():
    r = readings()
    assert r.trace.busy_us() == pytest.approx(100 + 150 + 120 + 50)
    assert r.trace.span_us() == 650.0
    r.unit_wall_ms = 0.42
    assert metric_reader("idle_share.edit").read(r) == pytest.approx(50.0)
    gaps = dict(r.trace.idle_gaps())
    # 100-150 under aten::conv2d, 300-400 under aten::copy_ (the launch
    # ended at 330), 520-600 under the outer span
    assert gaps == pytest.approx({"aten::conv2d": 50e-6, "aten::copy_": 100e-6,
                                  "python outer": 80e-6})
    top = r.trace.top_device_ops(2)
    assert {top[0][0], top[1][0]} == {"flash_fwd64_kernel<false>", "ff_gate_res_kernel<320>"}
    assert top[0][1] == pytest.approx(100e-6)


def test_rooflines_against_the_work():
    r = readings()
    assert metric_reader("flash_roofline.edit").read(r) == pytest.approx(100 * 70 / 200)
    assert metric_reader("ff_roofline.edit").read(r) == pytest.approx(100 * 75 / 150)


def test_dropped_record_fails_the_reading():
    r = readings(trace=Trace([d for d in DEVICE if not d[0].startswith("ff_out")], HOST))
    with pytest.raises(DroppedRecords):
        metric_reader("ff_roofline.edit").read(r)
    r = readings(launches={"flash_attention": 3, "fused_geglu_ff": 1})
    with pytest.raises(DroppedRecords):
        metric_reader("flash_roofline.edit").read(r)


def test_no_kernel_reads_nothing():
    r = readings(trace=Trace([d for d in DEVICE if "flash" not in d[0]], HOST),
                 launches={"flash_attention": 0, "fused_geglu_ff": 1})
    assert metric_reader("flash_roofline.edit").read(r) is None
    assert readings(trace=None, unit_wall_ms=1.0).idle_share() is None
    assert readings().idle_share() is None  # no wall time of a unit


def test_spans_classes_mfu_and_memory():
    r = readings()
    assert metric_reader("stage_s.text_vae.edit").read(r) == pytest.approx(1.0)
    assert metric_reader("unet_step_ms.edit").read(r) == pytest.approx(10.0)
    assert metric_reader("unet_busy_ms.edit").read(r) == pytest.approx(0.21)
    assert metric_reader("copy_elementwise_ms.edit").read(r) == pytest.approx(0.06)
    assert metric_reader("mfu.edit").read(r) == pytest.approx(50.0)
    assert metric_reader("peak_mem_gib.edit").read(r) == pytest.approx(2.0)
