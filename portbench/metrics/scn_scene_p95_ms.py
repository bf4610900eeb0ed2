"""95th percentile, over every request of the window, of the time from
its submit to its logits on the host (ms)."""
from portbench.frozen.stats import percentile


def read(run):
    p = percentile(run.latencies_s(), 95)
    return None if p is None else 1e3 * p
