#!/usr/bin/env python3
"""Run one cell of the benchmark of ``insv2v_torch`` once, on the GPUs of
this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files name its configuration (``configs/``), traffic
(``traffic/``) and driver (``drivers/``). Set-up makes the weights on the
card from the seed and warms every shape the cell uses; the window then
runs whole units back to back and closes at the first unit that ends at
or after ``--seconds``. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read by
``metrics/<name>.py`` from the window's spans and a profiled stretch
after it. Last, with the program's state freed, the float32 reference
(``reference/``) checks what the window produced: each compared number
with its limit goes to standard error as the last lines, and into the
result line under ``checks``.

The last line of standard output is the result, one JSON object. No GPU,
too few of them, a missing program, JAX loaded, or a metric that reads
nothing: exit 1 with no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
CACHE = os.path.join(REPO, ".bench_cache")
# every build and kernel cache of the run at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:0] = [ROOT, REPO]

from harness import (Cell, Readings, benchmark_spec, cell_metrics, forbidden_modules,  # noqa: E402
                     log, metric_reader, nvidia_smi)


def info(*a):
    print(*a, flush=True)


def run_cell(spec: dict, cell, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """Set-up, window, readings and check of one run of ``cell``; the
    result line's object, or None where the run has to fail."""
    import torch

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    chips = cell.spec["chips"]
    driver = cell.driver().Driver(cell, seed, device, trace=trace)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - T0
    info(f"setup {setup_s:.3f} s")

    t0 = time.perf_counter()
    units = 0
    while True:
        driver.run_unit(units)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips)) if cuda else 0
    for line in driver.describe(units, wall):
        info(line)

    if trace:
        r = Readings(cell.name, units=units, window_s=wall, peak_bytes=peak)
        driver.readings(r, units, wall)
        metrics = {}
        for m in cell_metrics(spec, cell.name, "per_layer"):
            value = metric_reader(m["name"]).read(r)
            if value is None:
                log(f"run: per-layer metric {m['name']} read nothing in this cell")
                return None
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_extra = {"busy_s": r.trace.busy_us() / 1e6, "window_s": r.trace.span_us() / 1e6}
        breakdown = {"device_ops": r.trace.top_device_ops(),
                     "idle_gaps": r.host_trace.idle_gaps()}
    else:
        e2e = driver.end_to_end(units, wall)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(spec, cell.name, "end_to_end")}
        device_extra, breakdown = {}, None
    for name, m in metrics.items():
        info(f"{name} = {m['value']!r} {m['unit']}")

    found = forbidden_modules()
    if found:
        log(f"run: the process loaded {found}; the benchmark measures insv2v_torch alone")
        return None

    driver.release()
    t_check = time.perf_counter()
    numbers, _ = driver.check()
    limits = cell.spec["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = set(numbers) == set(limits) and all(v <= limits[k] for k, v in numbers.items())
    info(f"check: {time.perf_counter() - t_check:.3f} s")

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": chips,
                         "memory_peak_bytes": int(peak), **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = benchmark_spec()
    if args.workload not in {w["name"] for w in spec["workloads"]}:
        log(f"run: no cell {args.workload!r} in BENCHMARK.json")
        return 1
    cell = Cell.load(args.workload)
    import torch

    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"run: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 1
    try:
        import insv2v_torch  # noqa: F401
    except ImportError as e:
        log(f"run: the program insv2v_torch is not in this checkout ({e})")
        return 1
    info(f"card: {nvidia_smi()}; torch {torch.__version__} cuda {torch.version.cuda}")
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
