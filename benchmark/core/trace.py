"""The traced window: a ``torch.profiler`` trace reduced to plain lists.

:func:`summarize` turns the profiler's events into a dict that the
per-layer readers (``metrics/<name>.py``) take, so that they can be
tested on canned events:

    window      [start_us, end_us] of the benchmark's own span around the
                window's call, on the trace's clock
    steps       steps the call ran
    device_ops  [[name, start_us, dur_us, kind], ...], kind "kernel",
                "memcpy" or "memset"
    ranges      {label: [[start_us, end_us, device_us], ...]} of the
                program's profiler ranges (device_us: the device time of
                the kernels launched inside the range)
    cpu_ops     [[name, start_us, end_us], ...] host operations (for the
                idle gaps' labels)

Nothing here imports the program.
"""

from __future__ import annotations

import bisect

SPAN = "benchmark.window"  # the benchmark's own span around the window's call
LABELLED_GAPS = 2000  # the longest idle gaps labelled by the host's work; the rest summed


def _raw_events(prof):
    """(name, device_type, start_ns, end_ns, correlation_id,
    linked_correlation_id, is_user_annotation) of every event of a
    finished profile, read from kineto's results without building the
    profiler's Python event tree (which takes minutes at a window's
    millions of events)."""
    res = prof.profiler.kineto_results
    for e in res.events():
        annotation = getattr(e, "is_user_annotation", None)
        yield (e.name(), e.device_type(), e.start_ns(), e.end_ns(), e.correlation_id(),
               e.linked_correlation_id(), bool(annotation()) if annotation is not None else False)


def summarize(prof, steps: int, range_labels=()) -> dict:
    """The summary of a finished ``torch.profiler.profile``."""
    import torch

    cpu_type = torch.autograd.DeviceType.CPU
    labels = set(range_labels)
    span = None
    ranges: dict[str, list] = {r: [] for r in labels}
    op_start: dict[int, float] = {}  # a host op's correlation id -> its start
    device, cpu = [], []
    for name, kind, s, e, corr, linked, annotation in _raw_events(prof):
        s, e = s / 1e3, e / 1e3
        if kind == cpu_type:
            if name == SPAN:
                span = [s, e]
                continue
            if name in labels:
                ranges[name].append([s, e, 0.0])
            cpu.append([name, s, e])
            if corr and not linked:  # a frontend op (runtime calls link to theirs)
                op_start[corr] = s
            continue
        if annotation or name == SPAN or name in labels:
            continue  # the device-side copies of the host ranges
        low = name.lower()
        what = "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") else "kernel"
        device.append([name, s, e - s, what, linked])
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    # a range's device time: the kernels launched by host ops that start inside it
    for spans in ranges.values():
        spans.sort()
        starts = [r[0] for r in spans]
        for d in device:
            launched = op_start.get(d[4])
            if launched is None:
                continue
            k = bisect.bisect_right(starts, launched) - 1
            if k >= 0 and launched <= spans[k][1]:
                spans[k][2] += d[2]
    device = sorted((d[:4] for d in device), key=lambda d: d[1])
    cpu.sort(key=lambda c: c[1])
    return {"window": span, "steps": int(steps), "device_ops": device, "ranges": ranges, "cpu_ops": cpu}


def in_window(trace: dict) -> list:
    """The device operations that start inside the window."""
    a, b = trace["window"]
    return [d for d in trace["device_ops"] if a <= d[1] < b]


def busy_intervals(trace: dict) -> list[tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the
    window, as sorted disjoint (start, end) pairs."""
    a, b = trace["window"]
    out: list[list[float]] = []
    for _, s, d, _ in trace["device_ops"]:
        s0, e0 = max(s, a), min(s + d, b)
        if e0 <= s0:
            continue
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return [(s, e) for s, e in out]


def busy_us(trace: dict) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def window_us(trace: dict) -> float:
    a, b = trace["window"]
    return b - a


def idle_gaps(trace: dict) -> list[tuple[float, float]]:
    """The window's stretches in which no device operation runs."""
    a, b = trace["window"]
    gaps, t = [], a
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if b > t:
        gaps.append((t, b))
    return gaps


def host_label(trace: dict, at: float, first_update: float | None, scan: int = 256) -> str:
    """What the host was doing at time ``at``: the innermost host
    operation around it, else where in the call it falls."""
    cpu = trace["cpu_ops"]
    pos = bisect.bisect_right(cpu, at, key=lambda c: c[1])
    for k in range(pos - 1, max(-1, pos - 1 - scan), -1):
        name, s, e = cpu[k]
        if s <= at <= e:
            return name
    if first_update is not None and at < first_update:
        return "prologue: host code outside torch ops"
    return "host code outside torch ops"


def breakdown(trace: dict, label, first_update: float | None, top: int = 10) -> dict:
    """The device operations that took most time (by ``label(name)``)
    and the idle time by what the host was doing, each in seconds, at
    most ``top`` entries."""
    by_op: dict[str, float] = {}
    for name, _, d, _ in in_window(trace):
        key = label(name)
        by_op[key] = by_op.get(key, 0.0) + d / 1e6
    by_host: dict[str, float] = {}
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])
    for s, e in gaps[:LABELLED_GAPS]:
        key = host_label(trace, 0.5 * (s + e), first_update)
        by_host[key] = by_host.get(key, 0.0) + (e - s) / 1e6
    if len(gaps) > LABELLED_GAPS:
        by_host["shorter gaps, unlabelled"] = sum(e - s for s, e in gaps[LABELLED_GAPS:]) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
