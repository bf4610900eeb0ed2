"""Idle device ms a scene of the traced window whose innermost program
span is ``scene.wait`` (the drain's wait on the wave's last event;
``portbench.spans.idle_split``), over the traced waves' scenes."""
from portbench.spans import idle_ms, per_scene


def read(run):
    return per_scene(run, idle_ms(run, "scene.wait"))
