"""Seconds from the start of set-up (weights, pools, plans, warm-up waves;
the first run in a checkout also compiles the kernels) to the window."""


def read(run):
    return run.setup_s
