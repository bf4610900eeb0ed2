"""Device ms of a wave's prefill: the program's own CUDA events from the
prefill's start to its first token (``WaveStats.event_ms["prefill"]``),
averaged over the traced waves."""
from portbench.spans import event_ms


def read(run):
    vals = event_ms(run, "prefill")
    return None if vals is None else sum(vals) / len(vals)
