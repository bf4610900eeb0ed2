"""Small sizes of the two cells, at which a run drives the program and its
reference on the CPU in seconds."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SCN = "scn-unet-m16.rooms"
LM = "granite-8b-code.chat"
SMALL = {
    SCN: ({"spatial_size": 32, "capacity": 2048},
          {"clients": 3, "engine": {"batch": 2},
           "pool": {"room_seeds": [0, 1, 2], "points_per_unit": 6000.0,
                    "n_objects": 4},
           "request": {"room": {"choice": [0, 1, 2]}}, "trace_waves": 3}),
    LM: ({"num_hidden_layers": 2, "hidden_size": 128,
          "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
          "intermediate_size": 256, "vocab_size": 512},
         {"clients": 4, "engine": {"batch": 2, "prompt_len": 16, "max_new": 4},
          "pool": {"rows": 8},
          "request": {"row": {"int_range": [0, 8]},
                      "length": {"log_uniform": [4, 16]}},
          "check": {"sample": 64}, "trace_waves": 2}),
}


@pytest.fixture
def small_run():
    """``small_run(cell, seed, **kw)``: one run of the cell at its small
    size on the CPU, for ``seconds`` (default 1); ``mix_override`` replaces
    keys of the small mix."""
    import torch

    from portbench import harness

    def run(cell, seed=12345678901, seconds=1.0, trace=False,
            mix_override=None, **kw):
        cfg, mix = SMALL[cell]
        return harness.run_cell(cell, seed, seconds, trace,
                                torch.device("cpu"), config_override=cfg,
                                mix_override={**mix, **(mix_override or {})},
                                **kw)

    return run
