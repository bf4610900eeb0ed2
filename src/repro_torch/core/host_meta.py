"""Host-side AdMAC metadata builders (port of ``repro.core.host_meta``).

Sorted linear keys plus a vectorized binary search stand in for the paper's
banked spatial hash: every (voxel, kernel-offset) pair issues one
``searchsorted`` probe. Numpy on the host, so the whole offline pass (AdMAC
+ SOAR + SPADE + tiles) stays off the device until
``engine.plan.upload_scene_plan``. Outputs are bit-identical to the JAX
package's numpy twins (same tables, bitmasks and canonical orders).

``shard_halo_tables_np`` splits a conv's table over contiguous capacity
shards and lists the halo rows each pair of shards exchanges (the sharded
scenes of ``engine.shard``).

The streaming half (``StreamMetaState``) patches a LiDAR stream's tables
from one frame to the next instead of rebuilding them; its patched tables
equal ``build_cirf_np`` / ``transposed_coir_np`` on the re-packed frame,
bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.coir import COIR
from repro_torch.core.hashgrid import UpdatableSortedGrid, kernel_offsets
from repro_torch.sparse.tensor import MAX_RESOLUTION, PAD_COORD


def linear_key_np(coords: np.ndarray, resolution: int,
                  mask: np.ndarray | None = None) -> np.ndarray:
    """Numpy twin of ``sparse.tensor.linear_key`` (int32, same sentinel)."""
    if resolution > MAX_RESOLUTION:
        raise ValueError(
            f"resolution {resolution} > int32-safe max {MAX_RESOLUTION}")
    r = np.int32(resolution)
    c = np.asarray(coords).astype(np.int32)
    key = (c[..., 0] * r + c[..., 1]) * r + c[..., 2]
    sentinel = np.int32(resolution) ** 3
    if mask is not None:
        key = np.where(np.asarray(mask), key, sentinel)
    else:
        key = np.where(np.all(c >= 0, axis=-1), key, sentinel)
    return key.astype(np.int32)


class SortedGridNp:
    """Sorted-key index over an active-voxel set (the adjacency 'hash')."""

    def __init__(self, coords: np.ndarray, mask: np.ndarray, resolution: int):
        self.resolution = resolution
        keys = linear_key_np(coords, resolution, mask)
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.sorted_idx = order.astype(np.int32)

    def lookup(self, query_coords: np.ndarray,
               query_valid: np.ndarray) -> np.ndarray:
        """Indices into the voxel list for each query coord; -1 if absent."""
        r = self.resolution
        q = np.asarray(query_coords)
        in_bounds = np.all((q >= 0) & (q < r), axis=-1)
        valid = np.asarray(query_valid) & in_bounds
        qkey = linear_key_np(q, r, valid)
        pos = np.searchsorted(self.sorted_keys, qkey)
        pos = np.clip(pos, 0, self.sorted_keys.shape[0] - 1)
        found = valid & (self.sorted_keys[pos] == qkey)
        return np.where(found, self.sorted_idx[pos], -1).astype(np.int32)


def query_neighbors_np(
    out_coords: np.ndarray,
    out_mask: np.ndarray,
    in_coords: np.ndarray,
    in_mask: np.ndarray,
    offsets: np.ndarray,
    resolution: int,
    stride: int = 1,
) -> np.ndarray:
    """(V_out, K) input row at ``out_coords * stride + offsets[k]``, -1 absent."""
    grid = SortedGridNp(in_coords, in_mask, resolution)
    out_coords = np.asarray(out_coords)
    offsets = np.asarray(offsets)
    probe = out_coords[:, None, :] * stride + offsets[None, :, :]
    valid = np.broadcast_to(np.asarray(out_mask)[:, None],
                            (out_coords.shape[0], offsets.shape[0]))
    return grid.lookup(probe, valid)


def _pack_bitmask_np(indices: np.ndarray) -> np.ndarray:
    k = indices.shape[1]
    bits = ((indices >= 0).astype(np.uint32)
            << np.arange(k, dtype=np.uint32)[None, :])
    return bits.sum(axis=1, dtype=np.uint32)


def build_cirf_np(
    out_coords: np.ndarray,
    out_mask: np.ndarray,
    in_coords: np.ndarray,
    in_mask: np.ndarray,
    offsets: np.ndarray,
    resolution: int,
    stride: int = 1,
) -> COIR:
    """CIRF (out-major): ``indices[o, k]`` is the input voxel at
    ``out_coords[o] * stride + offsets[k]``."""
    idx = query_neighbors_np(out_coords, out_mask, in_coords, in_mask,
                             offsets, resolution, stride)
    return COIR(idx, _pack_bitmask_np(idx), np.asarray(out_mask))


def build_corf_np(
    out_coords: np.ndarray,
    out_mask: np.ndarray,
    in_coords: np.ndarray,
    in_mask: np.ndarray,
    offsets: np.ndarray,
    resolution: int,
    stride: int = 1,
) -> COIR:
    """CORF (in-major): output o is in the response field of input i at
    plane k iff ``o * stride + offsets[k] == i``."""
    out_res = max(resolution // stride, 1) if stride > 1 else resolution
    grid = SortedGridNp(out_coords, out_mask, out_res)
    in_coords = np.asarray(in_coords)
    offsets = np.asarray(offsets)
    diff = in_coords[:, None, :] - offsets[None, :, :]
    exact = np.all(diff % stride == 0, axis=-1)
    probe = diff // stride
    valid = np.asarray(in_mask)[:, None] & exact
    idx = grid.lookup(probe, valid)
    return COIR(idx, _pack_bitmask_np(idx), np.asarray(in_mask))


def transposed_coir_np(
    coarse_coords: np.ndarray,
    coarse_mask: np.ndarray,
    fine_coords: np.ndarray,
    fine_mask: np.ndarray,
    fine_resolution: int,
    kernel_size: int = 2,
    stride: int = 2,
) -> COIR:
    """Metadata of the transposed (upsampling) conv: the CORF of the
    coarse-to-fine strided pairing, read out-major over the fine rows."""
    offs = kernel_offsets(kernel_size, centered=False)
    return build_corf_np(coarse_coords, coarse_mask, fine_coords, fine_mask,
                         offs, fine_resolution, stride)


def shard_halo_tables_np(
    indices: np.ndarray,
    n_shards: int,
    halo: int = 0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Split an out-major ``(V, K)`` COIR index block over ``n_shards``
    contiguous capacity shards: per-shard local index blocks, and the send
    tables a halo exchange reads (numpy twin of the JAX package's, table
    for table).

    Shard ``s`` owns global rows ``[s*Vs, (s+1)*Vs)`` (``Vs = V //
    n_shards``). An output row's receptive field may reference input rows
    that other shards own, the *halo*. For every (owner ``d``, consumer
    ``s``) pair the sorted unique global rows ``s`` needs from ``d`` are
    collected; ``halo`` pads each pair to a fixed budget (0 sizes it to
    this block's worst pair; a positive budget that a pair overflows
    raises, so a pinned serving signature never drops rows).

    Returns ``(local_idx, send_rows, n_halo_rows)``:

    * ``local_idx`` ``(S, Vs, K)`` int32: the block in each shard's local
      buffer ``concat([own rows (Vs), halo rows (S*H)])``: ``[0, Vs)`` its
      own rows, ``Vs + d*H + j`` the j-th row received from shard ``d``,
      ``-1`` holes (unchanged);
    * ``send_rows`` ``(S, S, H)`` int32: ``send_rows[d, s]`` lists the rows
      shard ``d`` sends shard ``s``, local to ``d``; ``-1`` pads;
    * ``n_halo_rows``: the real (non-pad) rows that cross shards, what a
      halo exchange of this conv moves.
    """
    idx = np.asarray(indices)
    V, _ = idx.shape
    S = int(n_shards)
    if S < 1 or V % S:
        raise ValueError(
            f"capacity {V} not divisible into {S} equal shards")
    Vs = V // S
    send_lists: list[list[np.ndarray]] = [[None] * S for _ in range(S)]
    h_needed = 0
    for s in range(S):
        blk = idx[s * Vs:(s + 1) * Vs]
        rows = np.unique(blk[blk >= 0])
        remote = rows[(rows < s * Vs) | (rows >= (s + 1) * Vs)]
        owners = remote // Vs
        for d in range(S):
            send_lists[d][s] = remote[owners == d]
            h_needed = max(h_needed, len(send_lists[d][s]))
    H = int(halo) if halo else max(h_needed, 1)
    if h_needed > H:
        raise ValueError(
            f"halo budget {H} rows/pair < required {h_needed}; raise the "
            "ShardLayout halo (or re-pin it from representative scenes)")
    send_rows = np.full((S, S, H), -1, np.int32)
    local_idx = np.empty((S, Vs, len(idx[0])), np.int32)
    n_halo = 0
    for s in range(S):
        glob2loc = np.full((V,), -1, np.int32)
        glob2loc[s * Vs:(s + 1) * Vs] = np.arange(Vs, dtype=np.int32)
        for d in range(S):
            rows = send_lists[d][s]
            n_halo += len(rows)
            send_rows[d, s, :len(rows)] = (rows - d * Vs).astype(np.int32)
            glob2loc[rows] = Vs + d * H + np.arange(len(rows), dtype=np.int32)
        blk = idx[s * Vs:(s + 1) * Vs]
        local_idx[s] = np.where(blk >= 0, glob2loc[np.maximum(blk, 0)], -1)
    return local_idx, send_rows, n_halo


def downsample_coords_np(
    coords: np.ndarray,
    mask: np.ndarray,
    resolution: int,
    factor: int = 2,
    capacity_out: int | None = None,
):
    """Unique ``coords // factor`` in sorted-key order -> (coords, mask)."""
    coords = np.asarray(coords)
    mask = np.asarray(mask)
    cap_out = capacity_out or coords.shape[0]
    r_out = max(resolution // factor, 1)
    down = np.where(mask[:, None], coords // factor, PAD_COORD)
    keys = linear_key_np(down, r_out, mask)
    sorted_keys = np.sort(keys)
    is_first = np.concatenate(
        [[True], sorted_keys[1:] != sorted_keys[:-1]]
    ) & (sorted_keys < np.int32(r_out) ** 3)
    dest = np.cumsum(is_first.astype(np.int32)) - 1
    out_keys = np.full((cap_out,), np.int32(2**31 - 1))
    keep = is_first & (dest < cap_out)
    out_keys[dest[keep]] = sorted_keys[keep]
    n_out = int(is_first.sum())
    out_mask = np.arange(cap_out) < n_out
    out_coords = np.stack(
        [
            out_keys // (r_out * r_out),
            (out_keys // r_out) % r_out,
            out_keys % r_out,
        ],
        axis=-1,
    ).astype(np.int32)
    out_coords = np.where(out_mask[:, None], out_coords, PAD_COORD)
    return out_coords, out_mask


# ---------------------------------------------------------------------------
# Streaming: delta-based incremental metadata for overlapping LiDAR frames
# ---------------------------------------------------------------------------

_OFFS3 = kernel_offsets(3)                   # centered 3^3 submanifold stencil
_OFFS2 = kernel_offsets(2, centered=False)   # [0,2)^3 down/up pair stencil
_K3 = _OFFS3.shape[0]                        # 27
_K2 = _OFFS2.shape[0]                        # 8


def _key_offset(shift: np.ndarray, resolution: int) -> int:
    """Linear-key delta of a uniform coordinate shift (valid while every
    shifted coordinate stays inside ``[0, resolution)^3``)."""
    s = np.asarray(shift, np.int64)
    r = int(resolution)
    return int((s[0] * r + s[1]) * r + s[2])


def _decode_keys(keys: np.ndarray, resolution: int) -> np.ndarray:
    """Coordinates of valid linear keys (inverse of ``linear_key_np``)."""
    k = np.asarray(keys)
    r = resolution
    return np.stack([k // (r * r), (k // r) % r, k % r], axis=-1).astype(
        np.int32)


def _prefix_lookup(keys_sorted: np.ndarray, probe_coords: np.ndarray,
                   resolution: int) -> np.ndarray:
    """Neighbour lookup against a sorted-prefix active set (row == rank).

    Bit-identical to ``SortedGridNp.lookup`` when the voxel list is laid out
    as its own sorted-key prefix (the ``downsample_coords_np`` canonical
    order): the capacity-shaped grid's sentinel rows sort after every valid
    key and can never match a valid query, so the prefix alone suffices.
    """
    q = np.asarray(probe_coords)
    in_bounds = np.all((q >= 0) & (q < resolution), axis=-1)
    qkey = linear_key_np(q, resolution, in_bounds)
    if not len(keys_sorted):
        return np.full(qkey.shape, -1, np.int32)
    pos = np.searchsorted(keys_sorted, qkey)
    pos = np.minimum(pos, len(keys_sorted) - 1)
    found = in_bounds & (keys_sorted[pos] == qkey)
    return np.where(found, pos, -1).astype(np.int32)


@dataclass
class SceneDelta:
    """Row-level diff between consecutive frames of one stream.

    Rows of the previous frame refer to the stream's *canonical* (packed)
    layout; rows of the new frame refer to the caller's layout. Retained
    pairs are aligned (``retained_prev_rows[i]`` is the same voxel as
    ``retained_new_rows[i]``) and ordered by ascending new-frame linear key,
    as are ``added_new_rows``. Coordinates must be unique per frame.
    """

    retained_prev_rows: np.ndarray
    retained_new_rows: np.ndarray
    added_new_rows: np.ndarray
    removed_prev_rows: np.ndarray
    n_prev: int
    n_new: int

    @property
    def overlap(self) -> float:
        """Retained fraction relative to the larger of the two frames."""
        return len(self.retained_prev_rows) / max(self.n_prev, self.n_new, 1)


def diff_scene_np(
    prev_coords: np.ndarray,
    prev_mask: np.ndarray,
    new_coords: np.ndarray,
    new_mask: np.ndarray,
    resolution: int,
    ego_shift=(0, 0, 0),
) -> SceneDelta:
    """Added/removed/retained voxel sets after ego-motion re-basing.

    ``ego_shift`` is the sensor translation in voxel units: a previous-frame
    voxel at ``c`` re-bases to ``c - ego_shift`` in the new frame's local
    coordinates. Previous voxels shifted outside ``[0, resolution)^3`` are
    removed; the rest match against the new frame by linear key.
    """
    shift = np.asarray(ego_shift, np.int32).reshape(3)
    prev_coords = np.asarray(prev_coords)
    new_coords = np.asarray(new_coords)
    prev_act = np.flatnonzero(np.asarray(prev_mask)).astype(np.int32)
    new_act = np.flatnonzero(np.asarray(new_mask)).astype(np.int32)
    nk = linear_key_np(new_coords[new_act], resolution)
    order = np.argsort(nk, kind="stable")
    snk, snr = nk[order], new_act[order]
    reb = prev_coords[prev_act] - shift
    inb = np.all((reb >= 0) & (reb < resolution), axis=-1) \
        if len(prev_act) else np.zeros((0,), bool)
    rk = linear_key_np(reb[inb], resolution)
    order = np.argsort(rk, kind="stable")
    srk, spr = rk[order], prev_act[inb][order]
    if len(srk):
        pos = np.searchsorted(srk, snk)
        hit = srk[np.minimum(pos, len(srk) - 1)] == snk
    else:
        pos = np.zeros(len(snk), np.int64)
        hit = np.zeros(len(snk), bool)
    if len(snk):
        back = np.searchsorted(snk, srk)
        kept = snk[np.minimum(back, len(snk) - 1)] == srk
    else:
        kept = np.zeros(len(srk), bool)
    removed = np.concatenate([prev_act[~inb], spr[~kept]])
    removed.sort()
    return SceneDelta(
        retained_prev_rows=spr[np.minimum(pos, max(len(srk) - 1, 0))][hit]
        if len(srk) else spr[:0],
        retained_new_rows=snr[hit],
        added_new_rows=snr[~hit],
        removed_prev_rows=removed.astype(np.int32),
        n_prev=int(len(prev_act)),
        n_new=int(len(new_act)),
    )


def pack_stream_frame_np(frame_rows: np.ndarray,
                         values: np.ndarray) -> np.ndarray:
    """Permute caller-layout per-row values into the stream's canonical
    layout (``frame_rows[i]`` = canonical row of caller row i, -1 inactive).
    Inactive canonical rows are zero-filled."""
    frame_rows = np.asarray(frame_rows)
    values = np.asarray(values)
    out = np.zeros(values.shape, values.dtype)
    act = frame_rows >= 0
    out[frame_rows[act]] = values[act]
    return out


@dataclass
class StreamFrameMeta:
    """One stream step's geometry + patched metadata, ready for assembly.

    ``levels[li] = (coords, mask, sub_coir)``; ``pairs[li] = (down_coir,
    up_coir)`` for the (li, li+1) strided pair. ``changed`` / ``pair_changed``
    say which tables differ from the previous frame's (unchanged entries are
    the *same array objects*, enabling device-upload memoization upstream).
    """

    mode: str                       # "rebuilt" | "patched" | "reused"
    overlap: float
    frame_rows: np.ndarray          # caller row -> canonical row (-1 pad)
    levels: list = field(default_factory=list)
    pairs: list = field(default_factory=list)
    changed: list = field(default_factory=list)
    pair_changed: list = field(default_factory=list)
    info: dict = field(default_factory=dict)


class StreamMetaState:
    """Per-stream incremental host-metadata state.

    Holds the previous frame's canonical geometry, per-level sorted key
    prefixes, active-child counts and COIR tables, plus a level-0
    ``UpdatableSortedGrid``. ``step`` diffs the incoming frame against the
    cached state and *patches* the tables — O(copy + churn·K·log V) instead
    of the from-scratch O(V·K·log V) searchsorted sweep — falling back to a
    full rebuild on high churn, empty frames, or an ego shift that is not
    divisible by the coarsest level's stride product.

    Patched tables are bitwise-identical to ``build_cirf_np`` /
    ``transposed_coir_np`` on the packed frame (held against a from-scratch
    pyramid and the JAX package's tables in ``tests/test_torch_streaming.py``).
    """

    def __init__(self, resolution: int, capacity: int, n_levels: int):
        if resolution % (1 << (n_levels - 1)):
            raise ValueError(
                f"resolution {resolution} not divisible by 2^{n_levels - 1}")
        self.resolution = resolution
        self.capacity = capacity
        self.n_levels = n_levels
        self.n: list | None = None  # None until the first frame

    # -- full (re)build ----------------------------------------------------

    def reset(self, coords: np.ndarray, mask: np.ndarray) -> None:
        """Adopt ``(coords, mask)`` as the canonical layout, from scratch."""
        coords = np.ascontiguousarray(np.asarray(coords, np.int32))
        mask = np.ascontiguousarray(np.asarray(mask, bool))
        geo = []
        c, m, res = coords, mask, self.resolution
        for li in range(self.n_levels):
            geo.append((c, m, res))
            if li < self.n_levels - 1:
                c, m = downsample_coords_np(c, m, res, 2)
                res = max(res // 2, 1)
        self.coords = [g[0] for g in geo]
        self.mask = [g[1] for g in geo]
        self.n = [int(g[1].sum()) for g in geo]
        self.keys = [None]
        self.counts: list = [None]
        self.grid = UpdatableSortedGrid.from_coords(coords, mask,
                                                    self.resolution)
        self.sub = []
        self.down = []
        self.up = []
        for li, (c, m, res) in enumerate(geo):
            self.sub.append(build_cirf_np(c, m, c, m, _OFFS3, res))
            if li > 0:
                self.keys.append(
                    linear_key_np(c[: self.n[li]], res))
                fc, fm, fres = geo[li - 1]
                pk = linear_key_np(
                    np.asarray(fc)[np.asarray(fm)] // 2, res)
                rows = np.searchsorted(self.keys[li], pk)
                self.counts.append(np.bincount(
                    rows, minlength=self.capacity).astype(np.int32))
        for li in range(self.n_levels - 1):
            fc, fm, fres = geo[li]
            cc, cm, _ = geo[li + 1]
            self.down.append(
                build_cirf_np(cc, cm, fc, fm, _OFFS2, fres, stride=2))
            self.up.append(
                transposed_coir_np(cc, cm, fc, fm, fres, 2, 2))

    # -- one stream step ---------------------------------------------------

    def step(self, coords: np.ndarray, mask: np.ndarray,
             ego_shift=(0, 0, 0), *,
             min_overlap: float = 0.5) -> StreamFrameMeta:
        """Advance the stream by one frame; returns patched metadata.

        ``coords``/``mask`` are the caller's layout; the returned
        ``frame_rows`` maps caller rows into the canonical layout (identity
        on a rebuild, retained-row-preserving on a patch).
        """
        coords = np.asarray(coords, np.int32)
        mask = np.asarray(mask, bool)
        if coords.shape[0] != self.capacity:
            raise ValueError(
                f"frame capacity {coords.shape[0]} != {self.capacity}")
        shift = np.asarray(ego_shift, np.int32).reshape(3)
        div = 1 << (self.n_levels - 1)
        fallback = None
        delta = None
        if self.n is None:
            fallback = "first_frame"
        elif np.any(shift % div):
            fallback = "ego_shift_alignment"
        else:
            delta = diff_scene_np(self.coords[0], self.mask[0], coords, mask,
                                  self.resolution, shift)
            if delta.n_new == 0 or delta.n_prev == 0:
                fallback = "empty_frame"
            elif delta.overlap < min_overlap:
                fallback = "churn"
        if fallback is not None:
            self.reset(coords, mask)
            frame_rows = np.where(
                mask, np.arange(self.capacity, dtype=np.int32), np.int32(-1))
            meta = self._emit("rebuilt", 0.0 if delta is None
                              else delta.overlap, frame_rows,
                              [True] * self.n_levels,
                              [True] * (self.n_levels - 1))
            meta.info["fallback"] = fallback
            return meta
        if (not len(delta.added_new_rows) and not len(delta.removed_prev_rows)
                and not shift.any()):
            frame_rows = np.full((self.capacity,), -1, np.int32)
            frame_rows[delta.retained_new_rows] = delta.retained_prev_rows
            return self._emit("reused", delta.overlap, frame_rows,
                              [False] * self.n_levels,
                              [False] * (self.n_levels - 1))
        return self._patch(coords, shift, delta)

    def _emit(self, mode, overlap, frame_rows, changed,
              pair_changed) -> StreamFrameMeta:
        return StreamFrameMeta(
            mode=mode, overlap=float(overlap), frame_rows=frame_rows,
            levels=[(self.coords[li], self.mask[li], self.sub[li])
                    for li in range(self.n_levels)],
            pairs=[(self.down[li], self.up[li])
                   for li in range(self.n_levels - 1)],
            changed=list(changed), pair_changed=list(pair_changed),
            info={"n_active": self.n[0]},
        )

    def _patch(self, coords: np.ndarray, shift: np.ndarray,
               delta: SceneDelta) -> StreamFrameMeta:
        cap, res = self.capacity, self.resolution
        ret_p, ret_n = delta.retained_prev_rows, delta.retained_new_rows
        add_n, rem = delta.added_new_rows, delta.removed_prev_rows
        A, R = len(add_n), len(rem)
        changed = [False] * self.n_levels
        pair_changed = [False] * (self.n_levels - 1)

        # ---- level 0: rows are stable identities, patch copy in place ----
        prev_c0, prev_m0 = self.coords[0], self.mask[0]
        rem_coords_prev = prev_c0[rem]           # previous coordinate space
        rem_keys_prev = linear_key_np(rem_coords_prev, res)
        freeable = ~prev_m0.copy()
        freeable[rem] = True
        free = np.flatnonzero(freeable)
        assigned = free[:A].astype(np.int32)     # ascending rows for
        add_coords = coords[add_n]               # ascending added keys
        frame_rows = np.full((cap,), -1, np.int32)
        frame_rows[ret_n] = ret_p
        frame_rows[add_n] = assigned
        m0 = prev_m0.copy()
        m0[rem] = False
        m0[assigned] = True
        c0 = prev_c0.copy()
        c0[~m0] = PAD_COORD
        c0[ret_p] = coords[ret_n]
        c0[assigned] = add_coords
        # grid: delete removed (previous keys) -> ego shift -> insert added
        self.grid.delete(np.sort(rem_keys_prev))
        self.grid.shift(-_key_offset(shift, res))
        self.grid.insert(linear_key_np(add_coords, res), assigned)
        if A or R:
            sub = self.sub[0]
            T = np.asarray(sub.indices).copy()
            bm = np.asarray(sub.bitmask).copy()
            k_ar = np.arange(_K3, dtype=np.int32)
            touched = [rem, assigned]
            if R:
                # drop reciprocal entries pointing at removed voxels
                rv = T[rem]
                rvm = rv >= 0
                jj = rv[rvm]
                kk = np.broadcast_to(k_ar, rv.shape)[rvm]
                T[jj, _K3 - 1 - kk] = -1
                T[rem] = -1
                touched.append(jj)
            if A:
                probe = add_coords[:, None, :] + _OFFS3[None, :, :]
                add_idx = self.grid.lookup(probe, np.ones((A, _K3), bool))
                T[assigned] = add_idx
                avm = add_idx >= 0
                jj = add_idx[avm]
                kk = np.broadcast_to(k_ar, add_idx.shape)[avm]
                aa = np.broadcast_to(assigned[:, None], add_idx.shape)[avm]
                T[jj, _K3 - 1 - kk] = aa
                touched.append(jj)
            touched = np.unique(np.concatenate(
                [np.asarray(t, np.int32) for t in touched]))
            bm[touched] = _pack_bitmask_np(T[touched])
            self.sub[0] = COIR(T, bm, m0)
            changed[0] = True
        else:
            self.sub[0] = COIR(np.asarray(self.sub[0].indices),
                               np.asarray(self.sub[0].bitmask), m0)
        self.coords[0], self.mask[0] = c0, m0
        self.n[0] = int(delta.n_new)

        # fine-level delta threaded up the pyramid
        f_add_rows, f_add_coords = assigned, add_coords        # new space
        f_rem_rows, f_rem_coords = rem, rem_coords_prev        # prev space
        f_remap = np.arange(cap, dtype=np.int32)
        f_remap[rem] = -1
        # retained level-0 rows: active before AND not removed (a freed row
        # reused by an added voxel is active in both masks but not retained)
        f_kept = np.flatnonzero(prev_m0 & (f_remap >= 0)).astype(np.int32)
        f_kept_prev, f_kept_new = f_kept, f_kept
        f_mask = m0

        for li in range(1, self.n_levels):
            r_l = res >> li
            s_l = shift // (1 << li)
            n_prev = self.n[li]
            pkeys = self.keys[li]
            counts = self.counts[li]
            # removals (previous coordinate space)
            if len(f_rem_rows):
                rpk = linear_key_np(f_rem_coords // 2, r_l)
                dec = np.bincount(np.searchsorted(pkeys, rpk),
                                  minlength=n_prev).astype(np.int32)
            else:
                dec = np.zeros(n_prev, np.int32)
            c_after = counts[:n_prev] - dec
            kept = c_after > 0
            kept_prev_rows = np.flatnonzero(kept).astype(np.int32)
            rem_c_rows = np.flatnonzero(~kept).astype(np.int32)
            kept_keys = (pkeys[kept] - np.int32(
                _key_offset(s_l, r_l))).astype(np.int32)
            # additions (new coordinate space)
            if len(f_add_rows):
                upar, ucnt = np.unique(
                    linear_key_np(f_add_coords // 2, r_l),
                    return_counts=True)
            else:
                upar = np.empty(0, np.int32)
                ucnt = np.empty(0, np.int64)
            if len(kept_keys) and len(upar):
                pos = np.searchsorted(kept_keys, upar)
                hit = kept_keys[np.minimum(
                    pos, len(kept_keys) - 1)] == upar
            else:
                pos = np.zeros(len(upar), np.int64)
                hit = np.zeros(len(upar), bool)
            ins_keys = upar[~hit].astype(np.int32)
            ins_cnt = ucnt[~hit].astype(np.int32)
            n_ins = len(ins_keys)
            # merged sorted layout (no re-sort: two searchsorted merges)
            ins_before = np.searchsorted(ins_keys, kept_keys)
            kept_new_rows = (np.arange(len(kept_keys)) +
                             ins_before).astype(np.int32)
            ins_new_rows = (np.searchsorted(kept_keys, ins_keys) +
                            np.arange(n_ins)).astype(np.int32)
            new_keys = np.empty(len(kept_keys) + n_ins, np.int32)
            new_keys[kept_new_rows] = kept_keys
            new_keys[ins_new_rows] = ins_keys
            n_new = len(new_keys)
            if n_new > cap:
                raise AssertionError("coarse level overflow")  # unreachable
            c_remap = np.full(cap, -1, np.int32)
            c_remap[kept_prev_rows] = kept_new_rows
            new_counts = np.zeros(cap, np.int32)
            new_counts[kept_new_rows] = c_after[kept]
            if hit.any():
                new_counts[kept_new_rows[pos[hit]]] += ucnt[hit].astype(
                    np.int32)
            new_counts[ins_new_rows] = ins_cnt
            c_changed = bool(n_ins or len(rem_c_rows))
            shifted = bool(s_l.any())
            # geometry, mirroring downsample_coords_np's decode exactly
            if c_changed or shifted:
                out_keys = np.full((cap,), np.int32(2**31 - 1))
                out_keys[:n_new] = new_keys
                m_l = np.arange(cap) < n_new
                c_l = np.stack(
                    [out_keys // (r_l * r_l),
                     (out_keys // r_l) % r_l,
                     out_keys % r_l], axis=-1).astype(np.int32)
                c_l = np.where(m_l[:, None], c_l, PAD_COORD)
                if not c_changed:
                    m_l = self.mask[li]     # same n: reuse the mask leaf
            else:
                c_l, m_l = self.coords[li], self.mask[li]
            # coarse submanifold table: gather kept rows, probe inserted
            if c_changed:
                prev_T = np.asarray(self.sub[li].indices)
                T = np.empty((cap, _K3), np.int32)
                T[n_new:] = -1      # every row < n_new is kept or inserted
                pv = prev_T[kept_prev_rows]
                T[kept_new_rows] = np.where(
                    pv >= 0, c_remap[np.maximum(pv, 0)], -1)
                if n_ins:
                    ins_coords = c_l[ins_new_rows]
                    probe = ins_coords[:, None, :] + _OFFS3[None, :, :]
                    ins_idx = _prefix_lookup(new_keys, probe, r_l)
                    T[ins_new_rows] = ins_idx
                    k_ar = np.arange(_K3, dtype=np.int32)
                    ivm = ins_idx >= 0
                    jj = ins_idx[ivm]
                    kk = np.broadcast_to(k_ar, ins_idx.shape)[ivm]
                    aa = np.broadcast_to(
                        ins_new_rows[:, None], ins_idx.shape)[ivm]
                    T[jj, _K3 - 1 - kk] = aa
                bm = np.zeros(cap, np.uint32)
                bm[:n_new] = _pack_bitmask_np(T[:n_new])
                self.sub[li] = COIR(T, bm, m_l)
                changed[li] = True
            elif m_l is not self.mask[li]:
                self.sub[li] = COIR(np.asarray(self.sub[li].indices),
                                    np.asarray(self.sub[li].bitmask), m_l)
            # down/up pair (li-1, li): changed iff the fine delta is nonempty
            if len(f_add_rows) or len(f_rem_rows):
                prev_D = np.asarray(self.down[li - 1].indices)
                D = np.empty((cap, _K2), np.int32)
                D[n_new:] = -1
                D[ins_new_rows] = -1    # filled by the added-child scatter
                dv = prev_D[kept_prev_rows]
                D[kept_new_rows] = np.where(
                    dv >= 0, f_remap[np.maximum(dv, 0)], -1)
                # up table: each active fine row has exactly one valid entry,
                # at k* = (c mod 2) lexicographic, pointing at its parent —
                # no 8-wide gather or bitmask pack needed.
                prev_U = np.asarray(self.up[li - 1].indices)
                U = np.full((cap, _K2), -1, np.int32)
                fine_c = self.coords[li - 1]
                if len(f_kept_prev):
                    kc = fine_c[f_kept_new]
                    kst = (kc[:, 0] % 2) * 4 + (kc[:, 1] % 2) * 2 \
                        + (kc[:, 2] % 2)
                    U[f_kept_new, kst] = c_remap[
                        prev_U[f_kept_prev].max(axis=1)]
                if len(f_add_rows):
                    ac = f_add_coords
                    kk = (ac[:, 0] % 2) * 4 + (ac[:, 1] % 2) * 2 \
                        + (ac[:, 2] % 2)
                    prow = np.searchsorted(
                        new_keys, linear_key_np(ac // 2, r_l)).astype(
                            np.int32)
                    D[prow, kk] = f_add_rows
                    U[f_add_rows, kk] = prow
                dbm = np.zeros(cap, np.uint32)
                dbm[:n_new] = _pack_bitmask_np(D[:n_new])
                fact = np.flatnonzero(f_mask)
                fc_act = fine_c[fact]
                ubm = np.zeros(cap, np.uint32)
                ubm[fact] = np.uint32(1) << (
                    (fc_act[:, 0] % 2) * 4 + (fc_act[:, 1] % 2) * 2
                    + (fc_act[:, 2] % 2)).astype(np.uint32)
                self.down[li - 1] = COIR(D, dbm, m_l)
                self.up[li - 1] = COIR(U, ubm, f_mask)
                pair_changed[li - 1] = True
            # thread this level's delta up as the next level's fine delta
            if len(rem_c_rows):
                f_rem_coords = _decode_keys(pkeys[rem_c_rows], r_l)
            else:
                f_rem_coords = np.empty((0, 3), np.int32)
            f_rem_rows = rem_c_rows
            f_add_rows = ins_new_rows
            f_add_coords = (c_l[ins_new_rows] if n_ins
                            else np.empty((0, 3), np.int32))
            f_remap = c_remap
            f_kept_prev, f_kept_new = kept_prev_rows, kept_new_rows
            f_mask = m_l
            self.keys[li] = new_keys
            self.counts[li] = new_counts
            self.coords[li], self.mask[li] = c_l, m_l
            self.n[li] = n_new

        return self._emit("patched", delta.overlap, frame_rows,
                          changed, pair_changed)
