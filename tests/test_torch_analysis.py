"""``repro_torch.analysis``: every rule of the JAX package's
``tests/test_analysis.py`` has a port counterpart here, on the same seeded
violation, giving the same rule id; the port's own tree lints clean and
its lock graph is clean and live; the gates read the port's artifacts (op
traces, signature counts, the fused kernel's modeled shared memory).

Where a check takes package-free input (numpy tables, thread and
contextvar sources) the JAX pass runs beside the port's on it and both
must give the same findings.
"""
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis.lint as jlint
import repro.analysis.plan_check as jpc
import repro_torch.analysis.concurrency as conc
import repro_torch.analysis.hlo_gates as hg
import repro_torch.analysis.plan_check as pc
import repro_torch.analysis.runtime as rt
from repro_torch.analysis.findings import Finding, render
from repro_torch.analysis.lint import lint_repo, lint_source

REPO = Path(__file__).resolve().parents[1]


class NS:
    """Ad-hoc record standing in for a plan/tile/dispatch object."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _rules(findings):
    return [f.rule for f in findings]


def test_findings_render_sorted():
    f = [Finding("REPRO-L003", "b.py:2", "x"), Finding("REPRO-C001", "a.py:1",
                                                       "y")]
    assert render(f).splitlines() == ["REPRO-C001 a.py:1: y",
                                      "REPRO-L003 b.py:2: x"]
    assert f[0].to_dict() == {"rule": "REPRO-L003", "where": "b.py:2",
                              "message": "x"}


# ---------------------------------------------------------------------------
# lint (REPRO-L001..L005)
# ---------------------------------------------------------------------------

def _lint(src, rel="src/repro_torch/mod.py"):
    return lint_source(textwrap.dedent(src), rel)


def test_l001_deprecated_shim_import():
    f = _lint("from repro_torch.kernels.sspnna.ops import sspnna_conv\n")
    assert _rules(f) == ["REPRO-L001"]
    f = _lint("from repro_torch.core.sparse_conv import sparse_conv_cirf\n")
    assert _rules(f) == ["REPRO-L001"]


def test_l001_deprecated_shim_attribute():
    f = _lint("""
        import repro_torch.kernels.sspnna.ops as ops
        y = ops.sspnna_conv(0)
    """)
    assert _rules(f) == ["REPRO-L001"]
    f = _lint("""
        from repro_torch.kernels.sspnna import ops
        y = ops.sspnna_conv_from_plan(0)
    """)
    assert _rules(f) == ["REPRO-L001"]


def test_l001_defining_module_exempt():
    f = _lint("from repro_torch.core.sparse_conv import sparse_conv_cirf\n",
              rel="src/repro_torch/core/sparse_conv.py")
    assert f == []


def test_l002_host_sync_in_dispatch_stage():
    f = _lint("""
        import numpy as np
        import torch
        class S:
            def _dispatch_stage(self, x):
                torch.cuda.synchronize()
                a = x.item()
                b = x.cpu()
                c = x.tolist()
                d = host_array(x)
                return np.asarray(x)
    """)
    assert _rules(f) == ["REPRO-L002"] * 6


def test_l002_outside_hot_path_is_fine():
    f = _lint("""
        import numpy as np
        def plain(x):
            return np.asarray(x.cpu()).item()
    """)
    assert f == []


@pytest.mark.parametrize("src, rules", [
    ("""
        import threading
        t = threading.Thread(target=print)
        ok = threading.Thread(target=print, name="w", daemon=True)
    """, ["REPRO-L003", "REPRO-L003"]),
    ("""
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(2)
    """, ["REPRO-L003"]),
], ids=["thread", "executor"])
def test_l003_threads_same_as_jax(src, rules):
    src = textwrap.dedent(src)
    assert _rules(lint_source(src, "src/repro_torch/mod.py")) == rules == \
        _rules(jlint.lint_source(src, "src/repro/mod.py"))


def test_l004_contextvars_only_banned_in_serving():
    src = "import contextvars\n"
    assert _rules(lint_source(src, "src/repro_torch/serving/mod.py")) == \
        ["REPRO-L004"]
    assert lint_source(src, "src/repro_torch/engine/mod.py") == []


@pytest.mark.parametrize("timer", ["measure", "time_ms", "device_ms",
                                   "host_ms"])
def test_l005_readback_in_timed_closure(timer):
    f = _lint(f"""
        import numpy as np
        r = {timer}(lambda: np.asarray(0), 3)
        s = {timer}(lambda: f(0).item(), 3)
        t = {timer}(lambda: f(0).cpu(), 3)
    """)
    assert _rules(f) == ["REPRO-L005"] * 3


def test_l005_synchronize_is_the_correct_fence():
    f = _lint("""
        import torch
        r = time_ms(lambda: (f(0), torch.cuda.synchronize()), 5)
    """)
    assert f == []


def test_l005_resolves_local_function_closures():
    f = _lint("""
        def step():
            return f(0).item()
        r = device_ms(step, 5)
    """)
    assert _rules(f) == ["REPRO-L005"]


def test_allow_comment_suppresses():
    f = _lint("""
        import threading
        t = threading.Thread(target=print)  # analysis: allow[REPRO-L003]
    """)
    assert f == []


def test_lint_repo_is_clean():
    """The port, its examples and ``chip_smoke.py`` lint clean, and the
    pass does read all three."""
    from repro_torch.analysis.lint import LINT_TARGETS, iter_python_files

    files = {p.relative_to(REPO).as_posix()
             for p in iter_python_files(REPO, LINT_TARGETS)}
    assert "chip_smoke.py" in files
    assert any(f.startswith("examples/") and f.endswith("_torch.py")
               for f in files)
    assert "src/repro_torch/launch/dryrun.py" in files
    assert not any(f.startswith("src/repro/") for f in files)
    assert lint_repo(REPO) == []


# ---------------------------------------------------------------------------
# concurrency (REPRO-C001..C003)
# ---------------------------------------------------------------------------

def _extract(tmp_path, source, name="mod.py"):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / name).write_text(textwrap.dedent(source))
    return conc.extract(tmp_path)


def test_c001_backward_acquisition(tmp_path):
    findings, graph = _extract(tmp_path, """
        from repro_torch.analysis.runtime import ordered_lock
        A = ordered_lock("autotune")
        B = ordered_lock("plan_cache")
        def f():
            with A:
                with B:
                    pass
    """)
    assert ("autotune", "plan_cache") in {(s, d) for s, d, _ in graph.edges}
    assert "REPRO-C001" in _rules(findings)


def test_c001_via_call_closure(tmp_path):
    findings, graph = _extract(tmp_path, """
        from repro_torch.analysis.runtime import ordered_lock
        A = ordered_lock("plan_cache")
        B = ordered_lock("autotune")
        def inner():
            with B:
                pass
        def outer():
            with A:
                inner()
    """)
    assert ("plan_cache", "autotune") in {(s, d) for s, d, _ in graph.edges}
    assert findings == []


def test_c001_unknown_lock_name(tmp_path):
    findings, _ = _extract(tmp_path, """
        from repro_torch.analysis.runtime import ordered_lock
        X = ordered_lock("not-in-the-order")
    """)
    assert "REPRO-C001" in _rules(findings)


def test_subscript_lock_defined_after_use(tmp_path):
    findings, graph = _extract(tmp_path, """
        from repro_torch.analysis.runtime import ordered_lock
        A = ordered_lock("plan_cache")
        def use(entry):
            with A:
                with entry["dev_lock"]:
                    pass
        def make():
            return {"dev_lock": ordered_lock("plan_cache.dev")}
    """)
    assert ("plan_cache", "plan_cache.dev") in \
        {(s, d) for s, d, _ in graph.edges}
    assert findings == []


@pytest.mark.parametrize("call", ["EV.wait()", "torch.cuda.synchronize()",
                                  "time.sleep(1)", "fut.result()"])
def test_c002_blocking_call_under_lock(tmp_path, call):
    findings, _ = _extract(tmp_path, f"""
        import threading, time
        import torch
        from repro_torch.analysis.runtime import ordered_lock
        L = ordered_lock("plan_cache")
        EV = threading.Event()
        def f(fut):
            with L:
                {call}
    """)
    assert _rules(findings) == ["REPRO-C002"]


def test_c002_condvar_wait_exempt(tmp_path):
    findings, _ = _extract(tmp_path, """
        from repro_torch.analysis.runtime import ordered_condition
        C = ordered_condition("stream.plan")
        def f():
            with C:
                C.wait()
    """)
    assert findings == []


def test_c003_raw_threading_lock(tmp_path):
    findings, _ = _extract(tmp_path, """
        import threading
        L = threading.Lock()
    """)
    assert _rules(findings) == ["REPRO-C003"]


def test_repo_lock_graph_is_clean_and_live():
    findings, graph = conc.extract(REPO)
    assert findings == []
    pairs = {(s, d) for s, d, _ in graph.edges}
    assert ("stream.plan", "plan_cache") in pairs
    assert ("stream.plan", "plan_cache.dev") in pairs  # via adopt->_resolve
    assert set(graph.locks) == set(rt.LOCK_ORDER)
    # the pass reads the port only: no lock site under src/repro/
    assert all(w.startswith("src/repro_torch/")
               for sites in graph.locks.values() for w in sites)


# ---------------------------------------------------------------------------
# plan invariants (REPRO-P001..P006), beside the JAX pass on the same input
# ---------------------------------------------------------------------------

def _both(fn_name, *args):
    got = getattr(pc, fn_name)(*args)
    want = getattr(jpc, fn_name)(*args)
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    return got


def test_p001_coir_out_of_range():
    coir = NS(indices=np.array([[0], [5]], np.int32), bitmask=None)
    assert _rules(_both("check_coir", coir, 2, "c")) == ["REPRO-P001"]


def test_p001_bitmask_disagrees():
    idx = np.array([[0, -1], [1, 0]], np.int32)
    bad = NS(indices=idx, bitmask=np.array([3, 3], np.uint32))
    f = _both("check_coir", bad, 2, "c")
    assert _rules(f) == ["REPRO-P001"] and "bitmask" in f[0].where
    good = NS(indices=idx, bitmask=np.array([1, 3], np.uint32))
    assert _both("check_coir", good, 2, "c") == []
    # tensors on the port's side read the same
    assert pc.check_coir(NS(indices=torch.as_tensor(idx),
                            bitmask=torch.tensor([3, 3])), 2, "c") == f


def _tiles(orow, irow, li, counts):
    return NS(out_rows=np.asarray(orow, np.int32),
              in_rows=np.asarray(irow, np.int32),
              local_idx=np.asarray(li, np.int32),
              pair_counts=np.asarray(counts, np.int64))


_COIR2 = NS(indices=np.array([[0], [1]], np.int32), bitmask=None)
_MASK2 = np.array([True, True])


@pytest.mark.parametrize("case, rule, word", [
    ((([[0, 1]], [[0, 1]], [[[0], [1]]], [2]), None), None, None),
    ((([[0, 1], [0, 2]], [[0, 1], [0, 0]], [[[0], [1]], [[0], [-1]]],
       [2, 1]), None), "REPRO-P002", None),
    ((([[0, 9]], [[0, 1]], [[[0], [1]]], [2]), None), "REPRO-P003", None),
    ((([[0, 1]], [[0, 1]], [[[0], [1]]], [2]),
      dict(n_tiles=4, delta_o=2, delta_i=2)), "REPRO-P003", "n_tiles"),
    ((([[0, 1]], [[0, 1]], [[[0], [1]]], [1]), None), "REPRO-P004", None),
    ((([[0, 1]], [[0, 1]], [[[0], [-1]]], [1]), None), "REPRO-P004",
     "dropped"),
    ((([[0, 1]], [[1, 0]], [[[0], [1]]], [2]), None), "REPRO-P004", "wrong"),
], ids=["clean", "p002_twice", "p003_trash", "p003_dispatch",
        "p004_counts", "p004_dropped", "p004_wrong_source"])
def test_tile_checks_same_as_jax(case, rule, word):
    tables, dispatch = case
    f = _both("check_tiles", _tiles(*tables), _COIR2, _MASK2, 2, 2,
              None if dispatch is None else NS(**dispatch), "t")
    if rule is None:
        assert f == []
    else:
        assert rule in _rules(f)
        if word:
            assert any(word in x.message for x in f if x.rule == rule)


def _sharded(idx, send):
    return NS(indices=np.asarray(idx, np.int32),
              send_rows=np.asarray(send, np.int32))


def test_p005_sharded_clean_and_violations():
    s, vs, h = 2, 4, 2
    send = np.full((s, s, h), -1, np.int32)
    send[1, 0, 1] = 2
    own = np.zeros((s, vs, 1), np.int32)
    idx = own.copy()
    idx[0, 0, 0] = vs + 1 * h + 1
    assert _both("check_sharded_conv", _sharded(idx, send), vs, vs, s,
                 "p") == []
    idx_self = own.copy()
    idx_self[0, 0, 0] = vs + 0 * h + 0
    f = _both("check_sharded_conv", _sharded(idx_self, send), vs, vs, s, "p")
    assert any("itself" in x.message and x.rule == "REPRO-P005" for x in f)
    idx_unsent = own.copy()
    idx_unsent[0, 0, 0] = vs + 1 * h + 0
    f = _both("check_sharded_conv", _sharded(idx_unsent, send), vs, vs, s,
              "p")
    assert any("never send" in x.message for x in f)
    bad_send = send.copy()
    bad_send[1, 0, 1] = vs + 3
    f = _both("check_sharded_conv", _sharded(idx, bad_send), vs, vs, s, "p")
    assert any("send rows" in x.message.lower() for x in f)


@pytest.fixture(scope="module")
def built():
    from repro_torch import engine
    from repro_torch.data.scenes import N_CLASSES, make_scene
    from repro_torch.models.scn import UNetConfig
    from repro_torch.sparse.tensor import SparseVoxelTensor
    res, cap = 16, 512
    cfg = UNetConfig(widths=(8, 16), reps=1, resolution=res, capacity=cap,
                     n_classes=N_CLASSES)
    coords, feats, _, mask = make_scene(0, resolution=res, capacity=cap)
    t = SparseVoxelTensor(torch.as_tensor(coords), torch.as_tensor(feats),
                          torch.as_tensor(mask))
    spec = engine.build_plan_spec([t], cfg, mem_budget=64 * 1024)
    plan = engine.build_scene_plan_host(t, cfg, spec=spec, plan_tiles=True)
    return t, cfg, plan


def test_real_plan_is_clean(built):
    _, _, plan = built
    assert any(lvl.sub.tiles is not None for lvl in plan.levels)
    assert pc.check_scene_plan(plan) == []


def test_real_plan_corrupted_tables_are_caught(built):
    _, _, plan = built
    lvl = next(l for l in plan.levels if l.sub.tiles is not None)
    v = int(np.asarray(lvl.mask).shape[0])
    orow = np.array(lvl.sub.tiles.out_rows, np.int32, copy=True)
    orow[0, 0] = v + 7
    bad = NS(out_rows=orow,
             in_rows=np.asarray(lvl.sub.tiles.in_rows),
             local_idx=np.asarray(lvl.sub.tiles.local_idx),
             pair_counts=np.asarray(lvl.sub.tiles.pair_counts))
    f = pc.check_tiles(bad, lvl.sub.coir, np.asarray(lvl.mask), v, v,
                       None, "t")
    assert "REPRO-P003" in _rules(f)


def test_p006_cache_keys_rotate(built):
    from repro_torch.engine.autotune import CostTable
    from repro_torch.engine.plan import PlanCache
    t, cfg, _ = built
    cache = PlanCache(capacity=t.capacity)
    assert pc.check_cache_keys(cache, t, cfg, autotune=CostTable()) == []

    class Frozen:
        def __repr__(self):
            return "Frozen()"

    f = pc.check_cache_keys(cache, t, cfg, autotune=Frozen())
    assert any("no generation" in x.message for x in f)

    class Hidden:
        generation = 0

        def __repr__(self):
            return "Hidden()"

    f = pc.check_cache_keys(cache, t, cfg, breakers=Hidden())
    assert any(x.rule == "REPRO-P006" and "rotate" in x.message for x in f)


def test_plan_cache_under_runtime_lock_check(monkeypatch, built):
    monkeypatch.setenv("REPRO_LOCK_CHECK", "1")
    from repro_torch.engine.plan import PlanCache
    t, cfg, plan = built
    cache = PlanCache(capacity=t.capacity)
    assert isinstance(cache._lock, rt._CheckedLock)
    key = cache.key_for(t, cfg)
    assert cache.adopt(key, plan, device=False) is plan
    assert cache.adopt(key, plan, device=False) is plan
    assert cache.invalidate() == 1


# ---------------------------------------------------------------------------
# gates (REPRO-H001..H003)
# ---------------------------------------------------------------------------

def test_h001_flags_gather_and_scatter():
    x, i = torch.ones(16, 4), torch.tensor([1, 3])
    _, trace = hg.op_trace(lambda: torch.take(x, i))
    f = hg.forbidden_ops(trace, where="g")
    assert _rules(f) == ["REPRO-H001"] and "gather" in f[0].message
    _, trace = hg.op_trace(lambda: x[i])
    assert "gather" in hg.forbidden_ops(trace)[0].message
    _, trace = hg.op_trace(
        lambda: torch.zeros(8).index_add_(0, i, torch.ones(2)))
    f = hg.forbidden_ops(trace, where="s")
    assert any(x.rule == "REPRO-H001" and "scatter" in x.message for x in f)
    # profiler op names read the same
    assert _rules(hg.forbidden_ops(["aten::index_select", "aten::scatter_",
                                    "aten::index_put_"])) == \
        ["REPRO-H001"] * 3


def test_h001_exact_match_spares_collectives_and_clean_matmul():
    assert hg.forbidden_ops([
        "_c10d_functional.all_gather_into_tensor.default",
        "_c10d_functional.reduce_scatter_tensor.default",
        "aten.index_select_backward", "aten.gather_stats"]) == []
    _, trace = hg.op_trace(lambda: torch.ones(8, 8) @ torch.ones(8, 8))
    assert hg.forbidden_ops(trace) == []


def test_h001_only_kernels():
    kernels = ["void sspnna::tile_kernel<float, 2>(...)",
               "void at::native::vectorized_elementwise_kernel<4, "
               "at::native::FillFunctor<float>>(...)"]
    assert hg.only_kernels(kernels, ("tile_kernel", "FillFunctor")) == []
    f = hg.only_kernels(kernels + ["indexSelectLargeIndex"],
                        ("tile_kernel", "FillFunctor"))
    assert _rules(f) == ["REPRO-H001"]


def test_h001_fused_conv_op_trace_under_fake_cuda_tensors():
    """The fused conv's dispatched ops on fake CUDA tensors (the wrapper's
    fake launch): no gather or scatter op. Its plain version, on real CPU
    tensors, has both, and the gate says so."""
    from repro_torch.analysis.__main__ import fused_case, gate_fake_trace

    case = fused_case("cpu")
    assert gate_fake_trace(case) == []
    _, trace = hg.op_trace(case.fused)
    assert {op_family for op_family in map(hg.op_family, trace)} >= {
        "gather", "scatter"}


def test_h002_signature_budget():
    assert _rules(hg.gate_compile_budget(3, 2, where="engine")) == \
        ["REPRO-H002"]
    assert hg.gate_compile_budget(2, 2) == []
    assert hg.gate_compile_budget(NS(n_compilations=1), 1) == []
    assert _rules(hg.gate_compile_budget(NS(keys=lambda: [1, 2]), 1)) == \
        ["REPRO-H002"]
    with pytest.raises(TypeError):
        hg.signature_count(lambda x: x)


def test_h003_smem_budget():
    assert hg.gate_smem_budget(n_tiles=47, delta_o=16, c_in=8, c_out=8) == []
    f = hg.gate_smem_budget(n_tiles=47, delta_o=16, c_in=8, c_out=8,
                            budget=4096)
    assert _rules(f) == ["REPRO-H003"]
    # no geometry fits: a row of C=12000 f32 channels in 16 rows and 3
    # stages outgrows 227 KiB
    f = hg.gate_smem_budget(n_tiles=4, delta_o=16, c_in=12000, c_out=8)
    assert _rules(f) == ["REPRO-H003"] and "no launch geometry" in \
        f[0].message
    assert hg.modeled_smem_bytes(n_tiles=4, delta_o=16, c_in=12000,
                                 c_out=8) < 0


def _smem(m, k, sa, esize, w_bytes, stages):
    tables = (m * k + 2 * m + 2 * k + 1) * 4
    return stages * (m * sa * esize + w_bytes) + (tables + 15) // 16 * 16


def test_h003_geometry_copy_on_hand_worked_shapes():
    """``geometry`` against shapes worked by hand from
    ``sspnna_tile.cuh``: a small level (few rows: 32-row blocks, N split
    in two), a wide f32 level (128-row blocks, two warps across 64
    channels) and a bf16 one."""
    # 47 x 16 rows, C=N=8, f32: want 264 blocks; bm falls to 32, q=1 so
    # one warp; sa=12, sw=8 (8 % 16 != 0), w 8*8*4
    g = hg.geometry(47 * 16, 8, 8, 27, 4, 132)
    assert g == {"grid_x": 24, "grid_y": 1, "threads": 64,
                 "rows_per_block": 32, "channels_per_block": 8, "stages": 3,
                 "smem_bytes": _smem(32, 27, 12, 4, 8 * 8 * 4, 3)}
    # 131072 rows, C=N=64 f32: bm stays 128, bn 64 (q=8, two warps across),
    # threads 8*2*32 = 512 > 256 so bm halves to 64; sa=68, sw=72
    g = hg.geometry(131072, 64, 64, 27, 4, 132)
    assert g == {"grid_x": 2048, "grid_y": 1, "threads": 256,
                 "rows_per_block": 64, "channels_per_block": 64,
                 "stages": 3,
                 "smem_bytes": _smem(64, 27, 68, 4, 64 * 72 * 4, 3)}
    # bf16, 8192 rows, C=16 N=48: bm falls to 32 (256 blocks < 264), so N
    # splits in two: bn 24 (q=3, one warp), grid (256, 2); cp=16, sa=24,
    # sw=24
    g = hg.geometry(8192, 16, 48, 27, 2, 132)
    assert g == {"grid_x": 256, "grid_y": 2, "threads": 64,
                 "rows_per_block": 32, "channels_per_block": 24, "stages": 3,
                 "smem_bytes": _smem(32, 27, 24, 2, 16 * 24 * 2, 3)}


def test_gate_plan_smem_reads_every_tiled_conv(built):
    _, cfg, plan = built
    assert hg.gate_plan_smem(plan, cfg.widths) == []
    f = hg.gate_plan_smem(plan, cfg.widths, budget=1024)
    tiled = sum(lvl.sub.tiles is not None for lvl in plan.levels)
    assert _rules(f) == ["REPRO-H003"] * tiled


def test_geometry_match_gate():
    g = hg.geometry(752, 8, 8, 27)
    assert hg.gate_geometry_matches(dict(g, blocks_per_sm=2), g) == []
    f = hg.gate_geometry_matches(dict(g, stages=2), g)
    assert _rules(f) == ["REPRO-H003"] and "stages" in f[0].message


def test_hlo_pass_without_a_card_names_the_card():
    from repro_torch.analysis.__main__ import run_hlo

    if torch.cuda.is_available():
        pytest.skip("a card is present: the pass runs (tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        run_hlo(REPO)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_static_passes_clean(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "findings.json"
    assert main(["--skip", "hlo", "--json", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["n_findings"] == 0
    assert data["passes"] == ["lint", "locks", "plans"]
    assert set(data["lock_graph"]["locks"]) == set(rt.LOCK_ORDER)


def test_cli_counts_findings(tmp_path):
    from repro_torch.analysis.__main__ import main
    bad = tmp_path / "src" / "repro_torch"
    bad.mkdir(parents=True)
    (bad / "mod.py").write_text(
        "import threading\nL = threading.Lock()\n"
        "t = threading.Thread(target=print)\n")
    rc = main(["--root", str(tmp_path), "--only", "lint", "--only", "locks"])
    assert rc == 3  # L003 name + L003 daemon + C003 raw lock
