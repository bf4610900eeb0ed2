"""MB (10^6 bytes) a scene that the scene engine's drains brought to the
host (``WaveStats.readback_bytes``, the program's counter), over the
traced waves' scenes."""
from portbench.spans import per_scene, wave_sum


def read(run):
    total = wave_sum(run, "readback_bytes")
    return per_scene(run, None if total is None else total / 1e6)
