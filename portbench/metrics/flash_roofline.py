"""Share of its roofline bound that the bf16 flash kernel reached over the
traced waves' prefills: the least time the frozen work count of its
launches (one a layer a prefill, at the bf16 peak or the memory rate)
needs, over the profiler's device time of the kernel; only where the
program's launch counter matches that count."""
from portbench.frozen.kernels import is_flash_bf16
from portbench.frozen.stats import share_pct


def read(run):
    work = run.work.get("flash")
    tr = run.trace
    if work is None or tr is None:
        return None
    expect = run.work["flash_per_wave"] * run.counters.get("waves", 0)
    if run.counters.get("flash_launches") != expect:
        return None
    return share_pct(work.bound_s(), tr.device_seconds(is_flash_bf16))
