"""Host ms a wave from the engine's dispatch to its results drained
(``WaveStats.device_ms``: a host clock, though the program names it
"device"), averaged over the traced waves."""


def read(run):
    if not run.traced_stats:
        return None
    return sum(w.device_ms for w in run.traced_stats) / len(run.traced_stats)
