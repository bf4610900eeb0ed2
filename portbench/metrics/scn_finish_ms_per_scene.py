"""Host ms a scene of the scene engine's ``scene.finish`` spans (the
drain's host work after the copy: reshape, scatter, argmax, breakers), as
the device trace holds the program's ranges, over the traced waves'
scenes."""
from portbench.spans import per_scene, span_ms


def read(run):
    return per_scene(run, span_ms(run.trace, "scene.finish"))
