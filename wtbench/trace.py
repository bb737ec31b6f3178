"""Reading a ``torch.profiler`` trace of a measured stretch: the device's
busy intervals, each kernel's time, the host ranges around the idle gaps.

A ``Trace`` holds plain tuples taken from the profiler's kineto events, so
that the metric readers and the tests need no profiler: a synthetic trace
is three lists.
"""

from __future__ import annotations

import collections
import dataclasses

#: idle gaps that ``breakdown`` names, the longest first
GAPS_NAMED = 400


@dataclasses.dataclass
class Trace:
    """device: (name, start_ns, end_ns) of every activity on the device
    (kernels, copies, sets); host: (name, start_ns, end_ns) of the host's
    user ranges (the program's ``wt.*`` and the harness's ``wtbench.*``);
    t0_ns, t1_ns: the traced window."""
    device: list
    host: list
    t0_ns: int
    t1_ns: int

    @property
    def window_s(self):
        return (self.t1_ns - self.t0_ns) / 1e9


def from_profile(prof):
    """A Trace of a finished ``torch.profiler.profile``; the window is the
    harness's ``wtbench.window`` host range."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        span = (name, start, start + e.duration_ns())
        ranged = name.startswith(("wt.", "wtbench."))
        if str(e.device_type()).endswith("CUDA"):
            if not ranged:          # a range's shadow on the device is no work
                device.append(span)
        elif ranged:
            host.append(span)
    return Trace(device, host, *window_bounds(host))


def window_bounds(host, name="wtbench.window"):
    """(start, end) ns of the host range ``name`` (the traced stretch)."""
    spans = [(s, e) for n, s, e in host if n == name]
    if not spans:
        raise ValueError(f"no '{name}' range in the trace")
    return min(s for s, _ in spans), max(e for _, e in spans)


def union(intervals, lo, hi):
    """Merged (start, end) intervals clipped to [lo, hi], in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_s(tr):
    """Seconds of the window in which some activity ran on the device."""
    return sum(e - s for s, e in union(
        [(s, e) for _, s, e in tr.device], tr.t0_ns, tr.t1_ns)) / 1e9


def idle_pct(tr):
    """The share of the window in which nothing ran on the device, in %;
    None without a window or without device activity."""
    if tr.t1_ns <= tr.t0_ns or not tr.device:
        return None
    return 100.0 * (1.0 - busy_s(tr) / tr.window_s)


def idle_pct_of(result):
    """idle_pct of a run's traced stretch, None in a run without one."""
    tr = result.get("trace")
    return idle_pct(tr) if tr is not None else None


def per_batch_ms(result, field):
    """Host ms a batch in the tally's ``field`` (seconds) over the
    window's batches, None in a run without batches."""
    t = result.get("tally")
    if t is None or not t.batches:
        return None
    return getattr(t, field) * 1e3 / t.batches


def kernel_s(tr, name):
    """(seconds, launches) of the device activities whose name holds
    ``name`` inside the window."""
    hits = [(s, e) for n, s, e in tr.device
            if name in n and s >= tr.t0_ns and e <= tr.t1_ns]
    return sum(e - s for s, e in hits) / 1e9, len(hits)


def gaps(tr, min_ns=1000):
    """Idle (start, end) gaps of the device inside the window."""
    busy = union([(s, e) for _, s, e in tr.device], tr.t0_ns, tr.t1_ns)
    out, at = [], tr.t0_ns
    for s, e in busy:
        if s - at >= min_ns:
            out.append((at, s))
        at = e
    if tr.t1_ns - at >= min_ns:
        out.append((at, tr.t1_ns))
    return out


def _innermost(host, t):
    """The name of the shortest host range that holds time t, or 'none'."""
    best = None
    for n, s, e in host:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return best[0] if best else "none"


def breakdown(tr, top=10):
    """{"device_ops": [[name, s]...], "idle_gaps": [[host range, s]...]}:
    the device activities that took most time, summed by name, and the
    idle time of the ``GAPS_NAMED`` longest gaps summed by the innermost
    host range running at each gap's middle (``wtbench.window`` itself when
    the harness ran between the program's calls)."""
    by_op = collections.Counter()
    for n, s, e in tr.device:
        if s >= tr.t0_ns and e <= tr.t1_ns:
            by_op[n[:120]] += (e - s) / 1e9
    host = [h for h in tr.host if h[2] > tr.t0_ns and h[1] < tr.t1_ns]
    by_host = collections.Counter()
    longest = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    for s, e in longest:
        by_host[_innermost(host, (s + e) // 2)] += (e - s) / 1e9
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}
