"""What every cell of the benchmark shares: the files found by name, the
seeds, the device checks, weights made on the card from the seed, the
device trace of a profiled stretch and what is read from it, and the
result line.

Nothing here imports the program or JAX; the drivers import the program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16 (data sheet)
PEAK_BYTES = 3.35e12      # NVIDIA H100 SXM, HBM3
FORBIDDEN = ("jax", "jaxlib", "flax", "insv2v_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return read_json(REPO, "BENCHMARK.json")


def load_module(path: str, name: Optional[str] = None):
    """A module from a file, under a name of its own (metric files carry
    dots in their names)."""
    name = name or "bench_" + os.path.relpath(path, ROOT).replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell as its files give it: ``workloads/<name>.json`` names the
    configuration, the traffic and the driver."""

    name: str
    spec: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        spec = read_json(ROOT, "workloads", name + ".json")
        config = read_json(ROOT, "configs", spec["config"] + ".json")
        traffic = read_json(ROOT, "traffic", spec["traffic"] + ".json")
        return cls(name, spec, config, traffic)

    def driver(self):
        return load_module(os.path.join(ROOT, "drivers", self.spec["driver"] + ".py"))

    def path(self, rel: str) -> str:
        """A data file named by the traffic, relative to ``benchmark/``."""
        return os.path.join(ROOT, rel)


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


# --- weights ---------------------------------------------------------------

def seeded_weights(model, seed: int, device, dtype) -> Dict[str, "torch.Tensor"]:
    """Every tensor of ``model``'s state dict (a module built on the meta
    device), random from ``seed``: one normal draw on ``device`` in
    ``dtype`` over one flat buffer, then each tensor scaled in place. A
    matrix or kernel gets std fan_in ** -0.5 (unit gain, also where the
    published model starts at zero, so no path drops out of the output), a
    norm's weight 1 + 0.1 n and its bias 0.1 n, any other vector 0.02 n."""
    import torch

    norms = {name for name, m in model.named_modules()
             if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    with torch.no_grad():
        for k, s in shapes.items():
            n = math.prod(s)
            t = flat[at: at + n].view(s)
            at += n
            owner, _, leaf = k.rpartition(".")
            if len(s) >= 2:
                t.mul_(math.prod(s[1:]) ** -0.5)
            elif owner in norms and leaf == "weight":
                t.mul_(0.1).add_(1.0)
            elif owner in norms:
                t.mul_(0.1)
            else:
                t.mul_(0.02)
            out[k] = t
    return out


def load_weights(model, weights) -> None:
    """Hand ``weights`` to a meta-built ``model`` as its own tensors."""
    model.load_state_dict(weights, strict=True, assign=True)


# --- the device trace of a profiled stretch -------------------------------

@dataclasses.dataclass
class Trace:
    """Device operations and host ops of a profiled stretch, in
    microseconds from the profiler's start."""

    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                dev.append((e.name, float(tr.start), float(tr.end)))
            elif e.device_type == DeviceType.CPU:
                host.append((e.name, float(tr.start), float(tr.end)))
        dev.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])
        return cls(dev, host)

    def matching(self, fragments: Sequence[str]) -> List[Tuple[str, float, float]]:
        return [r for r in self.device_ops if any(f in r[0].lower() for f in fragments)]

    def span_us(self) -> float:
        """First device operation's start to the last one's end."""
        if not self.device_ops:
            return 0.0
        return max(r[2] for r in self.device_ops) - self.device_ops[0][1]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals."""
        out: List[List[float]] = []
        for _, s, e in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device operations, summed by the innermost
        host op that was running at each gap's middle."""
        import bisect

        busy = self.busy_intervals()
        starts = [s for _, s, _ in self.host_ops]
        by: Dict[str, float] = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            label = "host outside any op"
            # host ops nest: the latest-starting one still running is the innermost
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if self.host_ops[j][2] >= mid:
                    label = self.host_ops[j][0]
                    break
            by[label] = by.get(label, 0.0) + (s1 - e0) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Stretch:
    """The profiled stretch of a traced run, marked at the start of each
    of its whole units: units [0, n) with the device's activity alone
    (busy time, kernels and rooflines, with the program's launch counters
    read around them), then units [n, n + m) with the host's ops too,
    which only label the idle gaps (tracing the host slows it). ``mark``
    returns True once the stretch is over."""

    def __init__(self, counters, n: int, m: int):
        self.counters, self.n, self.m = counters, n, m
        self.prof = self.host_prof = None
        self.launches: Dict[str, int] = {}

    def mark(self, i: int) -> bool:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if i not in (0, self.n, self.n + self.m):
            return False
        torch.cuda.synchronize()
        if i == 0:
            self.before = self.counters()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            return False
        if i == self.n:
            self.prof.stop()
            after = self.counters()
            self.launches = {k: after[k] - self.before[k] for k in after}
            self.host_prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.host_prof.start()
            return False
        self.host_prof.stop()
        return True

    def fill(self, r: "Readings"):
        r.trace = Trace.from_profiler(self.prof)
        r.host_trace = Trace.from_profiler(self.host_prof)
        r.stretch_calls = self.n
        r.launches = self.launches


class DroppedRecords(RuntimeError):
    """The profiler's kernel count disagrees with the program's counter."""


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the traced window's spans and
    counts, the profiled stretch and the work its kernels had to do."""

    cell: str
    units: int = 0                 # whole units in the traced window
    window_s: float = 0.0          # its wall seconds
    flops_per_unit: float = 0.0    # model FLOPs of a unit (reference, meta device)
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)  # summed seconds
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)  # summed counts
    peak_bytes: int = 0
    trace: Optional[Trace] = None
    host_trace: Optional[Trace] = None   # the stretch's tail, with host ops
    stretch_calls: int = 0         # model calls in the profiled stretch
    unit_wall_ms: float = 0.0      # host-clock ms a unit of the stretch's kind, in the window
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # counters, stretch
    work: Dict[str, List[Tuple[float, float]]] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, fragments, counter: str, per_launch: int) -> Optional[float]:
        """Device seconds of the kernels named by ``fragments`` in the
        stretch; None where there are none. Their count has to equal the
        program's launch counter times ``per_launch``."""
        if self.trace is None:
            return None
        ops = self.trace.matching(fragments)
        expected = self.launches.get(counter, 0) * per_launch
        if len(ops) != expected:
            raise DroppedRecords(f"{fragments}: {len(ops)} kernels in the trace, the program "
                                 f"counted {expected}")
        if not ops:
            return None
        return sum(e - s for _, s, e in ops) / 1e6

    def roofline(self, fragments, counter: str, per_launch: int, work: str) -> Optional[float]:
        """The kernels' least time for their work (operations at the bf16
        peak or bytes at the HBM peak, per launch) over their traced time,
        in %."""
        secs = self.kernel_seconds(fragments, counter, per_launch)
        items = self.work.get(work) or []
        if secs is None or not items:
            return None
        if len(items) != self.launches.get(counter, 0):
            raise DroppedRecords(f"{work}: {len(items)} launches of work reckoned, the program "
                                 f"counted {self.launches.get(counter, 0)}")
        least = sum(max(f / PEAK_BF16_FLOPS, b / PEAK_BYTES) for f, b in items)
        return 100.0 * least / secs

    def class_ms_per_call(self, classes: Sequence[str]) -> Optional[float]:
        """Device ms a model call of the stretch in the given kernel classes."""
        from kernel_classes import kernel_class

        if self.trace is None or not self.stretch_calls:
            return None
        us = sum(e - s for name, s, e in self.trace.device_ops if kernel_class(name) in classes)
        return us / 1e3 / self.stretch_calls

    def busy_ms_per_call(self) -> Optional[float]:
        if self.trace is None or not self.stretch_calls:
            return None
        return self.trace.busy_us() / 1e3 / self.stretch_calls

    def idle_share(self) -> Optional[float]:
        """1 - (device-busy ms a unit of the stretch) / (wall ms a unit of
        the same kind in the traced window, untraced: the profiler's own
        host overhead stays out), in %."""
        busy = self.busy_ms_per_call()
        if busy is None or not self.unit_wall_ms:
            return None
        return 100.0 * (1.0 - busy / self.unit_wall_ms)

    def mfu(self) -> Optional[float]:
        if not (self.units and self.window_s > 0 and self.flops_per_unit > 0):
            return None
        return 100.0 * self.units * self.flops_per_unit / self.window_s / PEAK_BF16_FLOPS


def metric_reader(name: str):
    return load_module(os.path.join(ROOT, "metrics", name + ".py"))


def cell_metrics(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    moves = {m["name"] for m in spec["end_to_end"]
             if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in moves:
            out.append(m)
    return out
