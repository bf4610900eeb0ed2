"""Frozen copies of what the benchmark measures with: the scene and token
generators, the traffic generator, the H100 peaks and the work counts.
A change to the program cannot move them."""
