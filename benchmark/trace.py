"""The traced run's window as plain numbers, for the per-layer readers.

A torch.profiler (CPU and CUDA activities) runs over the window; the
benchmark's own spans (`record_function`) mark the window and each call.
`reduce` turns the profile into a `Trace`.  Device busy time is the union
of the device events' intervals, so overlapping work counts once (the
arithmetic of supernova_tpu_torch/stats/profile_slice.py, copied), and
device events are told apart by the short names of PORT_KERNELS (the same
module's table of the port's kernels, copied).
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

from torch.autograd import DeviceType

# the device functions of the port's kernels K1-K4 (csrc/*.cu)
PORT_KERNELS = {
    "K1 kmer_extract": ("kmer_extract_kernel",),
    "K2 compact": ("compact_kernel",),
    "K3 run_reduce": ("tail_kernel", "run_reduce_kernel"),
    "K4 sort": ("hist_kernel", "onesweep_kernel"),
}
PORT_FUNCTIONS = frozenset(f for fns in PORT_KERNELS.values() for f in fns)
WINDOW_SPAN = "window"


def short_name(name: str) -> str:
    """A device event's name without `void`, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.sub(r"\(.*", "", name).strip()


@dataclass
class Trace:
    """Times in seconds from the profiler's origin."""

    window: tuple  # (start, end) of the window span
    device: list  # [(start, end, short name)] device events inside the window
    spans: dict  # span name -> [(start, end)] of the benchmark's spans
    host_ops: list = field(default_factory=list)  # [(start, end, name)] CPU operators
    peak_bytes: int = 0  # allocated peak over the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def busy_intervals(events, lo=float("-inf"), hi=float("inf")):
    """The union of the events' intervals clipped to [lo, hi], as a sorted
    list of disjoint (start, end)."""
    out = []
    for s, e, *_ in sorted(events):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(events, lo=float("-inf"), hi=float("inf")) -> float:
    return sum(e - s for s, e in busy_intervals(events, lo, hi))


def reduce(prof, peak_bytes: int) -> Trace:
    """A finished torch.profiler.profile -> Trace (the device events inside
    the window span only)."""
    spans: dict = {}
    host_ops = []
    device = []
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        ours = e.name == WINDOW_SPAN or e.name.startswith("call.")
        if e.device_type == DeviceType.CUDA:
            if not ours:  # a span's own annotation on the device's timeline is no work
                device.append((s, t, short_name(e.name)))
        elif ours:
            spans.setdefault(e.name, []).append((s, t))
        else:
            host_ops.append((s, t, e.name))
    (w0, w1), = spans.get(WINDOW_SPAN, [(0.0, 0.0)])
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    return Trace((w0, w1), device, spans, host_ops, peak_bytes)


def device_ops(tr: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the device operations with the most time in the
    window, most first."""
    tot: dict = {}
    for s, e, name in tr.device:
        tot[name] = tot.get(name, 0.0) + (min(e, tr.window[1]) - max(s, tr.window[0]))
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the longest gaps in the window with the device
    idle, each named by the innermost CPU operator running at its middle,
    else by the benchmark's span there and the first CPU operator after
    the gap began (host work outside torch, such as numpy, has no event
    of its own)."""
    busy = busy_intervals(tr.device, *tr.window)
    edges = [tr.window[0]] + [x for iv in busy for x in iv] + [tr.window[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    ops = sorted(tr.host_ops)
    starts = [o[0] for o in ops]
    out = []
    for length, s, e in gaps[:top]:
        mid = (s + e) / 2
        inner = [(t1 - t0, name) for t0, t1, name in ops if t0 <= mid <= t1]
        if inner:
            out.append([min(inner)[1], length])
            continue
        spans = [(t1 - t0, name) for name, ivs in tr.spans.items() for t0, t1 in ivs
                 if t0 <= mid <= t1]
        i = bisect.bisect_left(starts, s)
        name = min(spans)[1] if spans else "none"
        out.append([f"{name} before {ops[i][2]}" if i < len(ops) else name, length])
    return out


def per_call(tr: Trace, span: str):
    """The calls inside the window under `span`: [(start, end)], or None
    when the trace has no such span or no device event."""
    calls = [c for c in tr.spans.get(span, []) if tr.window[0] <= c[0] and c[1] <= tr.window[1]]
    return calls if calls and tr.device else None


def host_s(tr: Trace, span: str):
    """Mean seconds of a call with the device idle: its span's length less
    the union of the device's intervals inside it."""
    calls = per_call(tr, span)
    if calls is None:
        return None
    return sum((t - s) - busy_s(tr.device, s, t) for s, t in calls) / len(calls)


def device_s(tr: Trace, span: str, port: bool):
    """Mean device seconds a call spends in the port's kernels (port=True)
    or in every other device operation (port=False)."""
    calls = per_call(tr, span)
    if calls is None:
        return None
    tot = sum(busy_s([d for d in tr.device if (d[2] in PORT_FUNCTIONS) == port], s, t)
              for s, t in calls)
    return tot / len(calls)


def idle_share(tr: Trace, span: str):
    """1 - busy / window, for a window whose calls ran under `span`."""
    if per_call(tr, span) is None or tr.window_s <= 0:
        return None
    busy = busy_s(tr.device, *tr.window)
    return 1.0 - busy / tr.window_s if busy > 0 else None


def peak_gib(tr: Trace, span: str):
    if per_call(tr, span) is None or tr.peak_bytes <= 0:
        return None
    return tr.peak_bytes / 2**30
