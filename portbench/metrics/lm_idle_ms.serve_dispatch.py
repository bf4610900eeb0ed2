"""Idle device ms a wave of the traced window whose innermost program span
is ``serve.dispatch`` (the dispatch, outside the engine's own spans in it;
``portbench.spans.idle_split``), over the traced waves."""
from portbench.spans import idle_ms, per_wave


def read(run):
    return per_wave(run, idle_ms(run, "serve.dispatch"))
