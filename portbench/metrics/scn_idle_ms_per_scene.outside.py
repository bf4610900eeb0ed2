"""Idle device ms a scene of the traced window under no span of the
program (the harness's own work between waves;
``portbench.spans.idle_split``), over the traced waves' scenes."""
from portbench.spans import OUTSIDE, idle_ms, per_scene


def read(run):
    return per_scene(run, idle_ms(run, OUTSIDE))
