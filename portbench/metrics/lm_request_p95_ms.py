"""95th percentile, over every request of the window, of the time from
its submit to its last token on the host (ms). The engine hands every
token over at the wave's drain, so this is also when the user sees the
first one."""
from portbench.frozen.stats import percentile


def read(run):
    p = percentile(run.latencies_s(), 95)
    return None if p is None else 1e3 * p
