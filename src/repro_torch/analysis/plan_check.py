"""Structural validation of the port's built plans (port of
``repro.analysis.plan_check``).

The paper's metadata chain (COIR bitmasks -> SOAR orderings -> SSpNNA DMA
tables) is exactly where a silent bug becomes either a wrong answer or a
lost speedup. This pass takes *built* plan objects and checks the chain
end to end:

* ``REPRO-P001`` — COIR block inconsistent: indices out of ``[-1, n_in)``,
  non-integer dtype, or a bitmask that disagrees with the index holes.
* ``REPRO-P002`` — SOAR/tile coverage broken: some active (row, offset)
  pair is executed more than once across tiles (double accumulation).
* ``REPRO-P003`` — DMA table out of bounds for its capacity bucket:
  ``out_rows`` beyond the trash row, ``in_rows`` outside the input
  capacity, ``local_idx`` outside the working set, or tile shapes that
  disagree with the plan's ``Dispatch``.
* ``REPRO-P004`` — pair accounting broken: ``pair_counts`` disagrees with
  ``local_idx`` holes, a pair is dropped (the planner's ``dropped_pairs ==
  0`` invariant), pairs attached to a pad output slot, or the DMA chain
  resolves a pair to the wrong source row.
* ``REPRO-P005`` — sharded halo tables broken: send rows outside the
  sender's shard, references to halo slots nobody sends, self-halo.
* ``REPRO-P006`` — cache keys don't rotate: a ``PlanCache`` key that fails
  to mix ``_PLAN_VERSION``, topology, or the autotune/breaker generations
  serves stale plans after a flip.

``check_plan`` dispatches on plan type; every check returns
``list[Finding]`` (empty = clean) and never raises on malformed input.
Tables may be numpy arrays or tensors on any device; they are read on the
host.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.device import host_array


def _np(x):
    return None if x is None else host_array(x)


def check_coir(coir, n_in: int, path: str) -> list[Finding]:
    out: list[Finding] = []
    idx = _np(coir.indices)
    if idx is None:
        return [Finding("REPRO-P001", path, "COIR has no indices")]
    if not np.issubdtype(idx.dtype, np.integer):
        out.append(Finding("REPRO-P001", f"{path}.indices",
                           f"non-integer dtype {idx.dtype}"))
        return out
    if idx.ndim != 2:
        out.append(Finding("REPRO-P001", f"{path}.indices",
                           f"expected (V, K), got shape {idx.shape}"))
        return out
    lo, hi = int(idx.min(initial=0)), int(idx.max(initial=-1))
    if lo < -1 or hi >= n_in:
        out.append(Finding(
            "REPRO-P001", f"{path}.indices",
            f"values span [{lo}, {hi}], outside [-1, {n_in})"))
    bm = getattr(coir, "bitmask", None)
    if bm is not None and idx.shape[1] <= 32:
        k = idx.shape[1]
        want = ((idx >= 0).astype(np.uint32)
                * (np.uint32(1) << np.arange(k, dtype=np.uint32))).sum(
                    axis=1, dtype=np.uint64)
        got = _np(bm).astype(np.uint64)
        if got.shape == want.shape and not np.array_equal(got, want):
            n_bad = int((got != want).sum())
            out.append(Finding(
                "REPRO-P001", f"{path}.bitmask",
                f"bitmask disagrees with index holes on {n_bad} rows"))
    return out


def check_tiles(tiles, coir, mask, n_out: int, n_in: int, dispatch,
                path: str) -> list[Finding]:
    """Validate one conv's SSpNNA tile tables against its COIR block.

    The complete invariant: every active (out_row, offset) pair in the
    COIR block is executed exactly once across all tiles, and the DMA
    chain (``local_idx`` -> ``in_rows``) resolves it to the row COIR
    recorded. Plane-split rows (one row over several tiles) pass as long
    as no pair is duplicated or dropped.
    """
    out: list[Finding] = []
    orow, irow = _np(tiles.out_rows), _np(tiles.in_rows)
    li, pc = _np(tiles.local_idx), _np(tiles.pair_counts)
    if orow.ndim != 2 or irow.ndim != 2 or li.ndim != 3:
        return [Finding("REPRO-P003", path,
                        f"bad tile table ranks: out_rows{orow.shape} "
                        f"in_rows{irow.shape} local_idx{li.shape}")]
    t, d_o = orow.shape
    d_i = irow.shape[1]
    k = li.shape[2]
    if li.shape[:2] != (t, d_o) or irow.shape[0] != t or pc.shape != (t,):
        return [Finding("REPRO-P003", path,
                        f"tile table shapes disagree: out_rows{orow.shape} "
                        f"in_rows{irow.shape} local_idx{li.shape} "
                        f"pair_counts{pc.shape}")]
    if dispatch is not None:
        for attr, got in (("n_tiles", t), ("delta_o", d_o),
                          ("delta_i", d_i)):
            want = getattr(dispatch, attr, None)
            if want not in (None, 0) and want != got:
                out.append(Finding(
                    "REPRO-P003", f"{path}.dispatch",
                    f"dispatch.{attr}={want} but tables have {got}"))
    if orow.min(initial=0) < 0 or orow.max(initial=0) > n_out:
        out.append(Finding(
            "REPRO-P003", f"{path}.out_rows",
            f"values outside [0, {n_out}] (n_out={n_out} is the trash "
            f"row); got [{orow.min()}, {orow.max()}]"))
        return out
    if irow.min(initial=0) < 0 or irow.max(initial=0) >= n_in:
        out.append(Finding(
            "REPRO-P003", f"{path}.in_rows",
            f"values outside [0, {n_in}); got "
            f"[{irow.min()}, {irow.max()}]"))
        return out
    if li.min(initial=-1) < -1 or li.max(initial=-1) >= d_i:
        out.append(Finding(
            "REPRO-P003", f"{path}.local_idx",
            f"values outside [-1, {d_i}); got [{li.min()}, {li.max()}]"))
        return out
    valid = li >= 0
    want_counts = valid.sum(axis=(1, 2))
    if not np.array_equal(pc, want_counts):
        bad = np.flatnonzero(pc != want_counts)
        out.append(Finding(
            "REPRO-P004", f"{path}.pair_counts",
            f"disagrees with local_idx holes on tiles {bad[:8].tolist()}"))
    rows = np.broadcast_to(orow[:, :, None], li.shape)
    if bool((valid & (rows == n_out)).any()):
        out.append(Finding(
            "REPRO-P004", f"{path}.local_idx",
            "pairs attached to a pad (trash-row) output slot"))
    live = valid & (rows < n_out)
    if not live.any():
        return out
    tt = np.broadcast_to(np.arange(t)[:, None, None], li.shape)[live]
    kk = np.broadcast_to(np.arange(k)[None, None, :], li.shape)[live]
    rr = rows[live]
    src = irow[tt, li[live]]
    cidx = _np(coir.indices) if coir is not None else None
    if cidx is not None and cidx.shape == (n_out, k):
        want_src = cidx[rr, kk]
        bad = src != want_src
        if bool(bad.any()):
            out.append(Finding(
                "REPRO-P004", f"{path}.in_rows",
                f"DMA chain resolves {int(bad.sum())} pairs to the wrong "
                f"source row (local_idx -> in_rows != COIR)"))
        executed = np.bincount(rr * k + kk, minlength=n_out * k)
        m = _np(mask)
        active = cidx >= 0
        if m is not None and m.shape == (n_out,):
            active = active & m[:, None].astype(bool)
        expected = active.astype(np.int64).ravel()
        over = executed > expected
        under = executed < expected
        if bool(over.any()):
            rows_over = np.unique(np.flatnonzero(over) // k)
            out.append(Finding(
                "REPRO-P002", f"{path}.out_rows",
                f"{int(over.sum())} (row, offset) pairs executed more "
                f"than once (rows {rows_over[:8].tolist()}); SOAR "
                f"coverage must be a per-pair permutation"))
        if bool(under.any()):
            rows_under = np.unique(np.flatnonzero(under) // k)
            out.append(Finding(
                "REPRO-P004", f"{path}.out_rows",
                f"{int(under.sum())} active pairs dropped (rows "
                f"{rows_under[:8].tolist()}); dropped_pairs must be 0"))
    return out


def _check_conv(plan, n_out: int, n_in: int, mask, path: str
                ) -> list[Finding]:
    out = check_coir(plan.coir, n_in, f"{path}.coir")
    if getattr(plan, "tiles", None) is not None:
        out.extend(check_tiles(plan.tiles, plan.coir, mask, n_out, n_in,
                               getattr(plan, "dispatch", None),
                               f"{path}.tiles"))
    return out


def check_scene_plan(plan, path: str = "plan") -> list[Finding]:
    """Validate every conv site of a (host or device) ``ScenePlan``."""
    out: list[Finding] = []
    levels = list(plan.levels)
    if not levels:
        return [Finding("REPRO-P001", path, "plan has no levels")]
    sizes = [int(_np(lvl.mask).shape[0]) for lvl in levels]
    for li, lvl in enumerate(levels):
        v = sizes[li]
        p = f"{path}.levels[{li}]"
        coords, mask = _np(lvl.coords), _np(lvl.mask)
        if coords.shape != (v, 3):
            out.append(Finding("REPRO-P001", f"{p}.coords",
                               f"expected ({v}, 3), got {coords.shape}"))
        out.extend(_check_conv(lvl.sub, v, v, mask, f"{p}.sub"))
        if lvl.down is not None and li + 1 < len(levels):
            n_rows = int(_np(lvl.down.coir.indices).shape[0])
            n_in = sizes[li] if n_rows == sizes[li + 1] else sizes[li + 1]
            dmask = _np(levels[li + 1].mask) if n_rows == sizes[li + 1] \
                else mask
            out.extend(_check_conv(lvl.down, n_rows, n_in, dmask,
                                   f"{p}.down"))
        if lvl.up is not None and li + 1 < len(levels):
            n_rows = int(_np(lvl.up.coir.indices).shape[0])
            n_in = sizes[li + 1] if n_rows == sizes[li] else sizes[li]
            umask = mask if n_rows == sizes[li] else _np(levels[li + 1].mask)
            out.extend(_check_conv(lvl.up, n_rows, n_in, umask, f"{p}.up"))
    for li, st in enumerate(plan.stats or []):
        if isinstance(st, dict) and st.get("dropped_pairs", 0) != 0:
            out.append(Finding(
                "REPRO-P004", f"{path}.stats[{li}]",
                f"dropped_pairs={st['dropped_pairs']} (invariant: 0)"))
    return out


def check_sharded_conv(conv, vs_in: int, vs_out: int, n_shards: int,
                       path: str) -> list[Finding]:
    out: list[Finding] = []
    idx, send = _np(conv.indices), _np(conv.send_rows)
    s = n_shards
    if idx.ndim != 3 or idx.shape[0] != s:
        return [Finding("REPRO-P005", f"{path}.indices",
                        f"expected ({s}, Vs, K), got {idx.shape}")]
    if send.ndim != 3 or send.shape[:2] != (s, s):
        return [Finding("REPRO-P005", f"{path}.send_rows",
                        f"expected ({s}, {s}, H), got {send.shape}")]
    h = send.shape[2]
    if idx.shape[1] != vs_out:
        out.append(Finding("REPRO-P005", f"{path}.indices",
                           f"per-shard rows {idx.shape[1]} != {vs_out}"))
    if send.min(initial=0) < -1 or send.max(initial=-1) >= vs_in:
        out.append(Finding(
            "REPRO-P005", f"{path}.send_rows",
            f"send rows outside [-1, {vs_in}) (must be local to the "
            f"sending shard); got [{send.min()}, {send.max()}]"))
    hi = vs_in + s * h
    if idx.min(initial=-1) < -1 or idx.max(initial=-1) >= hi:
        out.append(Finding(
            "REPRO-P005", f"{path}.indices",
            f"local coding outside [-1, {hi}) "
            f"(own [0, {vs_in}) | halo [{vs_in}, {hi})); "
            f"got [{idx.min()}, {idx.max()}]"))
        return out
    for shard in range(s):
        slots = idx[shard][idx[shard] >= vs_in] - vs_in
        if slots.size == 0:
            continue
        d, j = slots // h, slots % h
        if bool((d == shard).any()):
            out.append(Finding(
                "REPRO-P005", f"{path}.indices",
                f"shard {shard} references a halo slot from itself "
                f"(own rows must use local coding)"))
        unsent = send[d, shard, j] < 0
        if bool(unsent.any()):
            out.append(Finding(
                "REPRO-P005", f"{path}.indices",
                f"shard {shard} references {int(unsent.sum())} halo "
                f"slots its peers never send (send_rows pad)"))
    return out


def check_sharded_scene_plan(plan, path: str = "plan") -> list[Finding]:
    out: list[Finding] = []
    s = plan.layout.n_shards
    levels = list(plan.levels)
    sizes = [int(_np(lvl.mask).shape[1]) for lvl in levels]
    for li, lvl in enumerate(levels):
        p = f"{path}.levels[{li}]"
        vs = sizes[li]
        if _np(lvl.mask).shape[0] != s:
            out.append(Finding("REPRO-P005", f"{p}.mask",
                               f"expected ({s}, Vs), got "
                               f"{_np(lvl.mask).shape}"))
            continue
        out.extend(check_sharded_conv(lvl.sub, vs, vs, s, f"{p}.sub"))
        if lvl.down is not None and li + 1 < len(levels):
            out.extend(check_sharded_conv(
                lvl.down, vs, sizes[li + 1], s, f"{p}.down"))
        if lvl.up is not None and li + 1 < len(levels):
            out.extend(check_sharded_conv(
                lvl.up, sizes[li + 1], vs, s, f"{p}.up"))
    return out


def check_stream_state(state, path: str = "stream") -> list[Finding]:
    from repro_torch.engine.plan import _PLAN_VERSION
    out: list[Finding] = []
    if f"v{_PLAN_VERSION}" not in state._tag:
        out.append(Finding(
            "REPRO-P006", f"{path}._tag",
            f"stream cache tag {state._tag!r} does not mix "
            f"_PLAN_VERSION={_PLAN_VERSION}"))
    if state._prev_plan is not None:
        out.extend(check_scene_plan(state._prev_plan, f"{path}.plan"))
    return out


def check_cache_keys(cache, t, cfg, *, autotune=None, breakers=None,
                     path: str = "plan_cache") -> list[Finding]:
    """Verify ``PlanCache`` keys rotate with everything that must rotate
    them: the table-layout ``_PLAN_VERSION``, the mesh topology, and the
    autotune/breaker generations (mixed in via their ``repr``)."""
    import repro_torch.engine.plan as plan_mod
    out: list[Finding] = []
    base = cache.key_for(t, cfg)
    old = plan_mod._PLAN_VERSION
    try:
        plan_mod._PLAN_VERSION = old + 1
        bumped = cache.key_for(t, cfg)
    finally:
        plan_mod._PLAN_VERSION = old
    if bumped == base:
        out.append(Finding("REPRO-P006", path,
                           "key does not mix _PLAN_VERSION"))
    if cache.key_for(t, cfg, topology="a") == \
            cache.key_for(t, cfg, topology="b"):
        out.append(Finding("REPRO-P006", path,
                           "key does not mix the mesh topology"))
    for label, obj in (("autotune", autotune), ("breakers", breakers)):
        if obj is None:
            continue
        k0 = cache.key_for(t, cfg, **{label: obj})
        if not hasattr(obj, "generation"):
            out.append(Finding(
                "REPRO-P006", path,
                f"{label} object {type(obj).__name__} has no generation "
                f"counter to mix into keys"))
            continue
        obj.generation += 1
        try:
            k1 = cache.key_for(t, cfg, **{label: obj})
        finally:
            obj.generation -= 1
        if k0 == k1:
            out.append(Finding(
                "REPRO-P006", path,
                f"key does not rotate with the {label} generation "
                f"({type(obj).__name__!s}.__repr__ must include it)"))
    return out


def check_plan(plan, path: str = "plan") -> list[Finding]:
    """Dispatch on plan type (``ScenePlan`` / ``ShardedScenePlan`` /
    ``StreamPlanState``)."""
    name = type(plan).__name__
    if name == "ShardedScenePlan" or hasattr(plan, "layout"):
        return check_sharded_scene_plan(plan, path)
    if name == "StreamPlanState" or hasattr(plan, "plan_frame"):
        return check_stream_state(plan, path)
    return check_scene_plan(plan, path)
