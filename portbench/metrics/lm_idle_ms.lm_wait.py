"""Idle device ms a wave of the traced window whose innermost program span
is ``lm.wait`` (the drain's wait on the wave's last event;
``portbench.spans.idle_split``), over the traced waves."""
from portbench.spans import idle_ms, per_wave


def read(run):
    return per_wave(run, idle_ms(run, "lm.wait"))
