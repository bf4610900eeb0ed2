"""The one traffic generator: a mix is a JSON file of parameters
(``portbench/traffic/<mix>.json``) that this module reads.

``loop`` says how requests arrive:

* ``"closed"``: ``clients`` callers, each sending its next request as soon
  as its previous one is answered;
* ``"open"``: requests arrive at times drawn from the seed, whether or not
  earlier ones are answered, by ``arrivals``:

  - ``{"periodic": {"rate_per_s": r, "streams": k}}``: ``k`` streams, each
    sending every ``1/r`` s from a phase drawn in ``[0, 1/r)`` (sensor
    sweeps);
  - ``{"bursts": {"rate_per_s": r, "size": [lo, hi]}}``: bursts arriving
    with exponential gaps of mean ``1/r``, each of ``lo``..``hi`` requests
    (uniformly) at one instant; ``size`` ``[1, 1]`` is a Poisson process.

  A request's latency runs from its arrival time, so time it waits behind
  a busy engine counts.

``request`` names each field of a request and how it is drawn from the
run's seed, in request order:

* ``{"choice": [a, b, ...]}``: one of the listed values, uniformly;
* ``{"int_range": [lo, hi]}``: an integer in [lo, hi), uniformly;
* ``{"log_uniform": [lo, hi]}``: an integer in [lo, hi], log-uniformly
  (the prompt-length draw).

The generator knows nothing of models: a family adapter turns a request's
fields into the program's request.
"""
from __future__ import annotations

import heapq
import json
from pathlib import Path

import numpy as np

DRAWS = ("choice", "int_range", "log_uniform")
ARRIVALS = {"periodic": {"rate_per_s", "streams"},
            "bursts": {"rate_per_s", "size"}}


def seed_sequence(seed: int, *tags: int) -> np.random.SeedSequence:
    """Entropy from a run's seed (any size of integer) and stream tags."""
    if seed < 0:
        raise ValueError(f"seed {seed} < 0")
    return np.random.SeedSequence([seed, *tags])


def load_mix(path: Path) -> dict:
    return check_mix(json.loads(Path(path).read_text()), path)


def check_mix(mix: dict, where="mix") -> dict:
    """``mix`` if its loop, arrivals and request draws are ones this
    generator knows; raises ValueError naming what is not."""
    loop = mix.get("loop")
    if loop == "closed":
        if int(mix.get("clients", 0)) < 1:
            raise ValueError(f"{where}: clients must be >= 1")
    elif loop == "open":
        arr = mix.get("arrivals", {})
        if len(arr) != 1 or next(iter(arr)) not in ARRIVALS:
            raise ValueError(f"{where}: arrivals {arr} is not one of "
                             f"{sorted(ARRIVALS)}")
        (kind, args), = arr.items()
        if set(args) != ARRIVALS[kind] or float(args["rate_per_s"]) <= 0:
            raise ValueError(f"{where}: {kind} arrivals take "
                             f"{sorted(ARRIVALS[kind])} with rate_per_s > 0, "
                             f"got {args}")
    else:
        raise ValueError(f"{where}: loop {loop!r} is not 'closed' or 'open'")
    for name, spec in mix.get("request", {}).items():
        if len(spec) != 1 or next(iter(spec)) not in DRAWS:
            raise ValueError(f"{where}: request field {name!r} is drawn by "
                             f"{spec}, not one of {DRAWS}")
    return mix


class RequestDraws:
    """The fields of request 0, 1, 2, ... of a run, drawn from its seed."""

    def __init__(self, mix: dict, seed: int):
        self.fields = mix.get("request", {})
        self.rng = np.random.default_rng(seed_sequence(seed, 1))
        self.n = 0

    def next(self) -> dict:
        out = {"index": self.n}
        for name, spec in self.fields.items():
            (kind, arg), = spec.items()
            if kind == "choice":
                out[name] = arg[int(self.rng.integers(len(arg)))]
            elif kind == "int_range":
                out[name] = int(self.rng.integers(arg[0], arg[1]))
            else:
                lo, hi = np.log(arg[0]), np.log(arg[1] + 1)
                out[name] = min(int(np.exp(self.rng.uniform(lo, hi))), arg[1])
        self.n += 1
        return out


class ArrivalTimes:
    """Arrival times (seconds from the window's start) of request 0, 1,
    2, ... of an open-loop run, drawn from its seed, in order."""

    def __init__(self, mix: dict, seed: int):
        (self.kind, self.args), = mix["arrivals"].items()
        self.rng = np.random.default_rng(seed_sequence(seed, 2))
        self.gap = 1.0 / float(self.args["rate_per_s"])
        self.t, self.pending = 0.0, 0
        if self.kind == "periodic":
            self.heap = [(float(self.rng.uniform(0, self.gap)), k)
                         for k in range(int(self.args["streams"]))]
            heapq.heapify(self.heap)

    def next(self) -> float:
        if self.kind == "periodic":
            t, k = heapq.heappop(self.heap)
            heapq.heappush(self.heap, (t + self.gap, k))
            return t
        if self.pending == 0:
            self.t += float(self.rng.exponential(self.gap))
            lo, hi = self.args["size"]
            self.pending = int(self.rng.integers(lo, hi + 1))
        self.pending -= 1
        return self.t
