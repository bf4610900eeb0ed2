"""Host ms a scene of the scene engine's ``scene.readback`` spans (the
wave's logits copied to the host, after the drain has waited on the
replay), as the device trace holds the program's ranges, over the traced
waves' scenes."""
from portbench.spans import per_scene, span_ms


def read(run):
    return per_scene(run, span_ms(run.trace, "scene.readback"))
