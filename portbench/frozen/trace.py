"""The reduction of a ``torch.profiler`` trace of the measured window to
what the per-layer metrics read: device operations with their times, the
runtime calls that launched them, the host's operations and the
benchmark's own spans, on one clock (nanoseconds).

A device operation is a kernel, a copy or a fill. A kernel that a CUDA
graph replay ran shares its correlation id with the ``cudaGraphLaunch``
call that launched it. Nothing here is a number the program computes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

GRAPH_LAUNCH = "cudaGraphLaunch"
#: the benchmark's own spans (``record_function``) start with this
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    t0_ns: int = 0
    t1_ns: int = 0
    #: (name, start_ns, end_ns, correlation id) of each device operation
    device: list = field(default_factory=list)
    #: correlation ids of ``cudaGraphLaunch`` calls
    graph_launches: set = field(default_factory=set)
    #: (name, start_ns, end_ns) of host operations and annotations
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals inside the window,
        sorted."""
        spans = sorted((max(s, self.t0_ns), min(e, self.t1_ns))
                       for _, s, e, _ in self.device)
        merged: list[list[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        """Intervals of the window in which no device operation ran."""
        gaps, t = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1_ns > t:
            gaps.append((t, self.t1_ns))
        return gaps

    def device_seconds(self, match=None) -> float:
        """Summed durations of the device operations whose name ``match``
        accepts (all without one)."""
        return sum(e - s for n, s, e, _ in self.device
                   if match is None or match(n)) / 1e9

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for n, s, e, _ in self.device:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def host_labels(self, times: list[int]) -> list[str]:
        """What the host was doing at each of ``times`` (ascending): the
        innermost host operation or span covering it, else ``"host
        idle"`` (one sweep over the host events)."""
        events = sorted(self.host, key=lambda h: h[1])
        active: list[tuple] = []
        out, i = [], 0
        for t in times:
            while i < len(events) and events[i][1] <= t:
                active.append(events[i])
                i += 1
            active = [h for h in active if h[2] > t]
            best = min(active, key=lambda h: h[2] - h[1], default=None)
            out.append(best[0] if best else "host idle")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and idle time by what
        the host was doing when each gap began, ``top`` of each."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle: dict[str, float] = {}
        gaps = self.idle_gaps()
        for (s, e), label in zip(gaps, self.host_labels([s for s, _ in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        worst = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in worst]}


def _on_device(evt) -> bool:
    return str(evt.device_type()).endswith("CUDA")


def _annotation(evt) -> bool:
    flag = getattr(evt, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def read_profile(prof, window: str) -> Trace:
    """The events of a finished ``torch.profiler.profile`` that overlap the
    span the benchmark annotated ``window`` (``record_function``), on the
    profiler's clock."""
    events = prof.profiler.kineto_results.events()
    spans = [(evt.start_ns(), evt.start_ns() + evt.duration_ns())
             for evt in events if evt.name() == window]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} spans named {window!r} in the trace")
    t0_ns, t1_ns = spans[0]
    # the host's annotations (``record_function``) also appear on the
    # device as ranges over their kernels: they are no device operation
    annotations = {evt.name() for evt in events
                   if not _on_device(evt) and _annotation(evt)}
    annotations |= {evt.name() for evt in events
                    if evt.name().startswith(SPAN_PREFIX)}
    tr = Trace(t0_ns, t1_ns)
    for evt in events:
        s = evt.start_ns()
        e = s + evt.duration_ns()
        if e <= t0_ns or s >= t1_ns:
            continue
        name = evt.name()
        if _on_device(evt):
            if not _annotation(evt) and name not in annotations:
                tr.device.append((name, s, e, evt.correlation_id()))
            continue
        if name == GRAPH_LAUNCH:
            tr.graph_launches.add(evt.correlation_id())
        tr.host.append((name, s, e))
    return tr
