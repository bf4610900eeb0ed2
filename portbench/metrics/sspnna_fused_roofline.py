"""Share of its roofline bound that ``sspnna_fused`` reached over the
traced waves: the least time the frozen work count of the window's
launches needs at the 3xTF32 rate (or the memory rate) over the profiler's
device time of the kernel. The work is counted from the reference's
rulebooks for the levels the program sends to the kernel, and only where
the launches the program's graph counter reports match that count."""
from portbench.frozen.kernels import is_sspnna_fused
from portbench.frozen.stats import share_pct


def read(run):
    work = run.work.get("sspnna_fused")
    tr = run.trace
    if work is None or tr is None:
        return None
    if run.work["sspnna_launches_per_wave"] != run.work["sspnna_per_wave"]:
        return None
    return share_pct(work.bound_s(), tr.device_seconds(is_sspnna_fused))
