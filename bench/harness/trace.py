"""Profile a slice of ticks with ``torch.profiler`` and reduce its trace.

Only device activity is recorded (CUPTI: kernels, copies and fills,
each with its start and end), so the host pays no per-operator cost
for the profile.  The harness stamps each tick with ``time.time_ns()``,
the clock the profiler's timestamps are on, so an idle stretch of the
device is told apart by what the host was doing then: inside a tick
that carries a prefill chunk, inside a decode-only tick, or between
ticks in the harness.

Kernel classes are a frozen copy of ``repro_torch.launch.profile_step``'s
patterns: cuBLAS / CUTLASS matrix products, and the port's paged
flash-decode kernels (``decode_*_kernel`` of ``flash_decode.cu``).
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)
FLASH_DECODE = re.compile(r"decode_\w+_kernel")


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Slice:
    window_s: float
    start_ns: int
    end_ns: int
    ops: List[DeviceOp]
    ticks: List = field(default_factory=list)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((o.start_ns, o.end_ns) for o in self.ops)
        merged: List[Tuple[int, int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds(self, pattern: re.Pattern) -> float:
        return sum(o.seconds for o in self.ops if pattern.search(o.name))


def short(name: str, width: int = 80) -> str:
    """A kernel's name without its return type, template and argument
    lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.strip()[:width] or "?"


def profile(run_ticks: Callable[[Callable[[], bool]], None],
            seconds: float, sync: Callable[[], None]) -> Slice:
    """Run ticks under the profiler until ``seconds`` have passed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        w0 = time.time_ns()
        t0 = time.perf_counter()
        run_ticks(lambda: time.perf_counter() - t0 >= seconds)
        sync()
        t1 = time.perf_counter()
        w1 = time.time_ns()
    ops = [DeviceOp(e.name(), int(e.start_ns()),
                    int(e.start_ns()) + int(e.duration_ns()))
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    return Slice(window_s=t1 - t0, start_ns=w0, end_ns=w1, ops=ops)


def _phase(tick) -> str:
    if tick.chunk is not None:
        return "tick with a prefill chunk"
    if tick.horizon > 1:
        return "fused decode tick"
    return "decode-only tick"


def breakdown(sl: Slice, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the idle time of
    the device by what the host was doing, each summed by name."""
    by_op: Dict[str, float] = {}
    for o in sl.ops:
        key = short(o.name)
        by_op[key] = by_op.get(key, 0.0) + o.seconds
    busy = sl.busy_intervals()
    ticks = [(t.wall_ns[0], t.wall_ns[1], _phase(t)) for t in sl.ticks]
    tick_starts = [t[0] for t in ticks]
    aligned = bool(busy) and busy[0][0] >= sl.start_ns - 10**9 \
        and busy[-1][1] <= sl.end_ns + 10**9
    starts = sorted(sl.ops, key=lambda o: o.start_ns)
    nxt_i = 0
    idle: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while nxt_i < len(starts) and starts[nxt_i].start_ns < b:
            nxt_i += 1
        nxt = short(starts[nxt_i].name if nxt_i < len(starts) else "?", 48)
        mid = (a + b) // 2
        what = "unaligned clocks"
        if aligned:
            i = bisect.bisect_right(tick_starts, mid) - 1
            what = (ticks[i][2] if i >= 0 and mid <= ticks[i][1]
                    else "harness between ticks")
        key = f"{what}; then {nxt}"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}
