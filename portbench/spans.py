"""What the metric readers take from the program's own records: the
``record_function`` ranges its serving path opens (``serve.*``,
``scene.*``, ``lm.*``) as they lie in the traced window's device trace
(``Trace.host``, on the profiler's clock), and the counters and event
timings on the traced waves' ``WaveStats``. A program without them (one
older than its spans) gives None, never an error."""
from __future__ import annotations

from portbench.frozen.stats import percentile

#: the prefixes of the program's span names
PROGRAM = ("serve.", "scene.", "lm.")
#: the idle time under no program span (the harness's own work)
OUTSIDE = "outside"


def span_ms(trace, name: str) -> float | None:
    """Summed ms of the host ranges named ``name`` inside the traced
    window, or None where there is none."""
    if trace is None:
        return None
    found = [(max(s, trace.t0_ns), min(e, trace.t1_ns))
             for n, s, e in trace.host if n == name]
    if not found:
        return None
    return sum(e - s for s, e in found if e > s) / 1e6


def per_scene(run, total: float | None) -> float | None:
    """``total`` over the traced waves' scenes."""
    scenes = run.total("scenes", traced=True)
    if total is None or not scenes:
        return None
    return total / scenes


def wave_sum(run, field: str) -> float | None:
    """The traced waves' ``WaveStats.<field>`` summed, or None where a
    wave lacks it or every wave reads 0."""
    vals = [getattr(w, field, None) for w in run.traced_stats]
    if not vals or any(v is None for v in vals) or not any(vals):
        return None
    return sum(vals)


def event_ms(run, key: str) -> list[float] | None:
    """Each traced wave's ``WaveStats.event_ms[key]``, or None where a wave
    lacks it (on the CPU, or a program without its events)."""
    vals = [getattr(w, "event_ms", {}).get(key) for w in run.traced_stats]
    if not vals or any(v is None for v in vals):
        return None
    return vals


def request_median(run, field: str) -> float | None:
    """The median over the traced waves' requests of the per-request
    ``WaveStats.<field>``, or None where there is none."""
    vals = [v for w in run.traced_stats for v in getattr(w, field, ())]
    return percentile(vals, 50)


def _stretches(spans: list) -> list:
    """``(start, end, innermost name)`` of the stretches between
    consecutive boundaries of ``spans`` (``(start, end, name)``) that some
    span covers; the innermost is the shortest that covers the stretch, as
    ``Trace.host_labels`` picks."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    spans = sorted(spans)
    out, active, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= a:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[1] > a]
        if active:
            inner = min(active, key=lambda sp: sp[1] - sp[0])
            out.append((a, b, inner[2]))
    return out


def idle_split(trace) -> dict[str, float] | None:
    """The traced window's idle device time (ms) by the innermost program
    span over it, with 0 for a span of the window that holds none, and under
    ``OUTSIDE`` the idle time no program span covers; None where the window
    holds no program span."""
    if trace is None:
        return None
    spans = [(max(s, trace.t0_ns), min(e, trace.t1_ns), n)
             for n, s, e in trace.host if n.startswith(PROGRAM)]
    spans = [sp for sp in spans if sp[1] > sp[0]]
    if not spans:
        return None
    split = dict.fromkeys({n for _, _, n in spans} | {OUTSIDE}, 0)
    stretches = _stretches(spans)
    j = 0
    for gs, ge in trace.idle_gaps():
        while j < len(stretches) and stretches[j][1] <= gs:
            j += 1
        covered, k = 0, j
        while k < len(stretches) and stretches[k][0] < ge:
            a, b, name = stretches[k]
            d = min(b, ge) - max(a, gs)
            split[name] += d
            covered += d
            k += 1
        split[OUTSIDE] += (ge - gs) - covered
    return {n: v / 1e6 for n, v in split.items()}


def idle_ms(run, span: str) -> float | None:
    """Idle ms of the traced window under the innermost program span
    ``span`` (or ``OUTSIDE``), or None where the window has no such span."""
    split = idle_split(run.trace)
    return None if split is None else split.get(span)


def per_wave(run, total: float | None) -> float | None:
    """``total`` over the traced waves."""
    if total is None or not run.traced_stats:
        return None
    return total / len(run.traced_stats)
