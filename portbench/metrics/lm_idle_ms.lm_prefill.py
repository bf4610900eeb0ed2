"""Idle device ms a wave of the traced window whose innermost program span
is ``lm.prefill`` (the prompts to the card and the prefill's launches;
``portbench.spans.idle_split``), over the traced waves."""
from portbench.spans import idle_ms, per_wave


def read(run):
    return per_wave(run, idle_ms(run, "lm.prefill"))
