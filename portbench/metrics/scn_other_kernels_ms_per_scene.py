"""Device ms a scene of every device operation other than ``sspnna_fused``
(the reference convs' gathers, products and scatters, BatchNorm, copies),
over the traced waves' scenes."""
from portbench.frozen.kernels import is_sspnna_fused


def read(run):
    tr = run.trace
    scenes = run.total("scenes", traced=True)
    if tr is None or not tr.device or not scenes:
        return None
    other = tr.device_seconds(lambda n: not is_sspnna_fused(n))
    return 1e3 * other / scenes
