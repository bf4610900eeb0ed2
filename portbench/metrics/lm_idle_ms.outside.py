"""Idle device ms a wave of the traced window under no span of the program
(the harness's own work between waves; ``portbench.spans.idle_split``),
over the traced waves."""
from portbench.spans import OUTSIDE, idle_ms, per_wave


def read(run):
    return per_wave(run, idle_ms(run, OUTSIDE))
