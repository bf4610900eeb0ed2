"""Idle device ms a scene of the traced window whose innermost program
span is ``serve.admit`` (the admission pass that formed a wave;
``portbench.spans.idle_split``), over the traced waves' scenes."""
from portbench.spans import idle_ms, per_scene


def read(run):
    return per_scene(run, idle_ms(run, "serve.admit"))
