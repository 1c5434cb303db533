"""The program's own spans and counters (supernova_tpu_torch/stats/trace.py `span`, `spans()`),
read for the per-layer metrics of the count's and the pather's steps.

A step's host seconds come from the trace (its record_function on the profiler's clock), its
device seconds from the program's span log (CUDA events at the step's ends), its bytes from the
counters in the log's entries.  Each reader gives the mean a call over the window's calls, and
None where the trace has no call with a device event, the program has no span log (a tree
before it), or the log does not hold one root span a call.
"""
from benchmark import trace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory rate, at 700 W
KERNELS = ("kmer_extract", "sort", "run_reduce", "compact")  # the wrappers' counter names


def window_log(tr, call_span: str, root: str):
    """(the window's calls, the program's span log) or None."""
    calls = trace.per_call(tr, call_span)
    if calls is None:
        return None
    from supernova_tpu_torch.stats import trace as program

    spans = getattr(program, "spans", None)
    if spans is None:
        return None
    log = spans()
    if sum(e["name"] == root for e in log) != len(calls):
        return None
    return calls, log


def host_s(tr, call_span: str, root: str, step: str):
    """Mean host seconds a call of the trace's `step` spans."""
    got = window_log(tr, call_span, root)
    if got is None:
        return None
    calls, _ = got
    ivs = [(s, t) for s, t in tr.spans.get(step, [])
           if any(c0 <= s and t <= c1 for c0, c1 in calls)]
    return sum(t - s for s, t in ivs) / len(calls) if ivs else None


def device_s(tr, call_span: str, root: str, step: str):
    """Mean device seconds a call of the log's `step` spans (their device
    intervals summed)."""
    got = window_log(tr, call_span, root)
    if got is None:
        return None
    calls, log = got
    vals = [e["device_s"] for e in log if e["name"] == step]
    if not vals or None in vals:
        return None
    return sum(vals) / len(calls)


def h2d_gb(tr, call_span: str, root: str):
    """Mean GB a call's uploads handed to the card."""
    got = window_log(tr, call_span, root)
    if got is None:
        return None
    calls, log = got
    return sum(e["h2d_bytes"] for e in log if e["name"] == root) / len(calls) / 1e9


def kernel_roofline(tr, call_span: str, root: str):
    """The calls' K1-K4 bytes over the device-memory rate, as a share (%) of
    the calls' device seconds in K1-K4's functions."""
    got = window_log(tr, call_span, root)
    if got is None:
        return None
    calls, log = got
    moved = sum(e[f"{k}.bytes"] for e in log if e["name"] == root for k in KERNELS)
    port = [d for d in tr.device if d[2] in trace.PORT_FUNCTIONS]
    secs = sum(trace.busy_s(port, c0, c1) for c0, c1 in calls)
    if moved <= 0 or secs <= 0:
        return None
    return 100.0 * moved / HBM_BYTES_PER_S / secs
