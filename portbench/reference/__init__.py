"""Plain PyTorch references of the benchmark's model families. They import
nothing of the program: they work out from the benchmark's own inputs and
weights what the program derives (rulebooks, caches)."""
