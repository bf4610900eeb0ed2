"""Device ms a scene of the scene engine's forward: the program's own CUDA
events around each traced wave's graph replay
(``WaveStats.event_ms["forward"]``), over the traced waves' scenes."""
from portbench.spans import event_ms, per_scene


def read(run):
    vals = event_ms(run, "forward")
    return per_scene(run, None if vals is None else sum(vals))
