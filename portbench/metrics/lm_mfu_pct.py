"""Model FLOPs of the traced window's requests (2 a weight for each real
prompt token and each generated token but the last, plus 4*H*D a layer for
each causal pair among them; padding not counted) over the traced window,
against the H100's bf16 peak."""
from portbench.frozen import peaks
from portbench.frozen.stats import share_pct


def read(run):
    tr = run.trace
    flops = run.work.get("model_flops")
    if tr is None or not flops:
        return None
    return share_pct(flops / tr.window_s, peaks.BF16_FLOPS)
