"""Model FLOPs of the traced window's scenes (2 * pairs * C * N of every
conv, pairs from each scene's own rulebook, and the head) over the traced
window, against the H100's 3xTF32 peak (an f32-accurate product)."""
from portbench.frozen import peaks
from portbench.frozen.stats import share_pct


def read(run):
    tr = run.trace
    flops = run.work.get("model_flops")
    if tr is None or not flops:
        return None
    return share_pct(flops / tr.window_s, peaks.F32_3XTF32_FLOPS)
