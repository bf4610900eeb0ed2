"""Share of the traced window's wall time in which no kernel, copy or fill
ran on the device (torch.profiler's device trace)."""
from portbench.frozen.stats import share_pct


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return share_pct(tr.window_s - tr.busy_s(), tr.window_s)
