"""Device ms a scene of the forward's ``rows`` (the wave plan's tables
moved to each scene's rows): the program's CUDA events captured in the
bucket's graph at ``apply_unet``'s level boundaries
(``WaveStats.event_ms["rows"]``), over the traced waves' scenes."""
from portbench.spans import event_ms, per_scene


def read(run):
    vals = event_ms(run, "rows")
    return per_scene(run, None if vals is None else sum(vals))
