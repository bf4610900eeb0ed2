"""Host ms a scene of the scene engine's ``scene.upload`` spans (plan
adoption, features to the card) and ``scene.stage`` spans (the wave's
plans and features stacked into the bucket's buffers), as the device trace
holds the program's ranges, over the traced waves' scenes."""
from portbench.spans import per_scene, span_ms


def read(run):
    parts = [span_ms(run.trace, n) for n in ("scene.upload", "scene.stage")]
    if all(p is None for p in parts):
        return None
    return per_scene(run, sum(p or 0.0 for p in parts))
