"""Tile binning: screen-space splats -> per-tile depth-ordered duplicate lists
(counterpart of gaussian_splatterer_tpu.ops.binning's ``tile_aabb``,
``bin_splats`` and ``bin_splats_batch``).

  1. depth-sort the splats (stable; invalid splats last, ties keep index
     order as JAX's stable argsort does),
  2. enumerate the (splat, covered tile) duplicates in depth order over each
     splat's ``tile_aabb`` rectangle, row-major within the rectangle,
  3. stable-sort the duplicates by tile id, which keeps depth order within
     each tile,
  4. per-tile ``[tile_start, tile_end)`` ranges by binary search.

The tile sort's permutation and each depth slot's duplicate range are
kept (``presort_pos``, ``seg_start``, ``seg_end``): the cumsum route of
the fused step's gradient reduction (raster_tiled.dup_grads_to_rows_cumsum)
carries the duplicates back to depth order with them.

The buffer is sized from the true duplicate count, capped at ``max_dup``:
as in the reference, duplicates past ``max_dup`` in depth order are dropped
and ``num_dup`` reports the true total, so a caller can tell it overflowed.
The TPU work list (``make_window_worklist``, chunk blocking) has no
counterpart: the CUDA compositor walks each tile's range itself.

A frame group (the fused training step's F frames) is binned in one pass
by ``bin_splats_batch``: one batched depth sort, one stable sort of the
group's duplicates by (frame, tile), one binary search.  ``bin_frames``
is the same result built frame by frame from ``bin_splats``.

Plain PyTorch integer bookkeeping; runs on any device.  One host sync reads
the duplicate counts (a frame's, or the group's F at once), which size the
buffers.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from gaussian_splatterer_tpu_torch.ops.transforms import SplatComponents


class TileBins(NamedTuple):
    """D = min(num_dup, max_dup) duplicates, T = number of tiles."""

    gather_idx: torch.Tensor  # (D,) int64 splat id per tile-sorted duplicate
    tile_start: torch.Tensor  # (T,) int32 first duplicate index of each tile
    tile_end: torch.Tensor  # (T,) int32 one past the last
    num_dup: int  # true duplicate total (may exceed max_dup)
    depth_order: torch.Tensor  # (N,) int64 splat id per depth slot
    presort_pos: torch.Tensor  # (D,) int64 depth-order position per tile-sorted duplicate
    seg_start: torch.Tensor  # (N,) int64 first kept duplicate (depth order) per depth slot
    seg_end: torch.Tensor  # (N,) int64 one past the last, clamped to D


def tile_aabb(mx, my, rx, ry, tile: int, tx_tiles: int, ty_tiles: int):
    """Per-splat covered tile rectangle [x0, x1) x [y0, y1), INRIA getRect
    semantics over per-axis half-extents, clipped to the tile grid.  All
    arguments and results are (N,) vectors; results are int64."""
    ftile = float(tile)
    x0 = torch.clamp(torch.floor((mx - rx) / ftile), 0, tx_tiles).to(torch.int64)
    y0 = torch.clamp(torch.floor((my - ry) / ftile), 0, ty_tiles).to(torch.int64)
    x1 = torch.clamp(torch.floor((mx + rx + ftile - 1.0) / ftile), 0, tx_tiles).to(torch.int64)
    y1 = torch.clamp(torch.floor((my + ry + ftile - 1.0) / ftile), 0, ty_tiles).to(torch.int64)
    return x0, y0, x1, y1


def bin_splats(comps: SplatComponents, width: int, height: int, tile: int,
               max_dup: int) -> TileBins:
    dev = comps.mx.device
    n = comps.mx.shape[0]
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    num_tiles = tx_tiles * ty_tiles

    # 1. depth order (invalid splats last; stable for deterministic ties)
    key = torch.where(comps.valid, comps.depth, torch.full_like(comps.depth, float("inf")))
    order = torch.sort(key, stable=True).indices
    x0, y0, x1, y1 = tile_aabb(
        comps.mx[order], comps.my[order], comps.rx[order], comps.ry[order],
        tile, tx_tiles, ty_tiles,
    )
    spans_x = torch.clamp(x1 - x0, min=0)
    ntiles = torch.where(comps.valid[order], spans_x * torch.clamp(y1 - y0, min=0), 0)
    offs = torch.cumsum(ntiles, 0)  # inclusive, int64: no wrap
    num_dup = int(offs[-1]) if n else 0
    d_count = min(num_dup, max_dup)

    # 2. duplicates in depth order, cut at max_dup
    kept = torch.clamp(offs, max=d_count) - torch.clamp(offs - ntiles, max=d_count)
    slot = torch.repeat_interleave(torch.arange(n, device=dev), kept, output_size=d_count)
    local = torch.arange(d_count, device=dev) - (offs - ntiles)[slot]
    width_of = torch.clamp(spans_x[slot], min=1)
    tid = (y0[slot] + local // width_of) * tx_tiles + x0[slot] + local % width_of

    # 3. stable sort by tile id: depth order survives within each tile
    tid_sorted, perm = torch.sort(tid, stable=True)
    gather_idx = order[slot[perm]]

    # 4. per-tile ranges
    tids = torch.arange(num_tiles, device=dev, dtype=tid_sorted.dtype)
    tile_start = torch.searchsorted(tid_sorted, tids, side="left").to(torch.int32)
    tile_end = torch.searchsorted(tid_sorted, tids, side="right").to(torch.int32)
    seg_start = torch.clamp(offs - ntiles, max=d_count)
    seg_end = torch.clamp(offs, max=d_count)
    return TileBins(gather_idx, tile_start, tile_end, num_dup, order, perm, seg_start, seg_end)


class FrameBins(NamedTuple):
    """The bins of F frames, concatenated so that one compositor launch
    covers all F x T (frame, tile) blocks, frame-major.  D = the sum of the
    frames' kept duplicates.  Duplicate positions are offset by the kept
    duplicates of the frames before, depth slots and row columns by f * N."""

    gather_idx: torch.Tensor  # (D,) int64 column in the frame-stacked (9, F*N) rows
    tile_start: torch.Tensor  # (F*T,) int32 first duplicate of each (frame, tile)
    tile_end: torch.Tensor  # (F*T,) int32 one past the last
    num_dup: int  # max over frames of the true duplicate count
    frame_dups: tuple  # (F,) kept duplicates of each frame, host ints
    presort_pos: torch.Tensor  # (D,) int64 depth-order position per tile-sorted duplicate
    seg_start: torch.Tensor  # (F*N,) int64 first kept duplicate per depth slot
    seg_end: torch.Tensor  # (F*N,) int64 one past the last
    depth_order: torch.Tensor  # (F*N,) int64 row column per depth slot


def bin_frames(comps_frames: Sequence[SplatComponents], width: int, height: int,
               tile: int, max_dup: int) -> FrameBins:
    """Bin each frame with ``bin_splats`` (each keeps at most ``max_dup``
    duplicates) and offset its tile ranges into the concatenation."""
    frames = [bin_splats(c, width, height, tile, max_dup) for c in comps_frames]
    parts = {k: [] for k in ("gather", "start", "end", "pos", "seg_start", "seg_end", "order")}
    offset = 0
    for f, (c, b) in enumerate(zip(comps_frames, frames)):
        n = c.mx.shape[0]
        parts["gather"].append(b.gather_idx + f * n)
        parts["start"].append(b.tile_start + offset)
        parts["end"].append(b.tile_end + offset)
        parts["pos"].append(b.presort_pos + offset)
        parts["seg_start"].append(b.seg_start + offset)
        parts["seg_end"].append(b.seg_end + offset)
        parts["order"].append(b.depth_order + f * n)
        offset += b.gather_idx.shape[0]
    if offset >= 2**31:
        raise ValueError(f"{offset} duplicates in one frame group exceed int32 tile ranges")
    cat = {k: torch.cat(v) for k, v in parts.items()}
    return FrameBins(cat["gather"], cat["start"], cat["end"], max(b.num_dup for b in frames),
                     tuple(b.gather_idx.shape[0] for b in frames), cat["pos"],
                     cat["seg_start"], cat["seg_end"], cat["order"])


def bin_splats_batch(comps: SplatComponents, width: int, height: int, tile: int,
                     max_dup: int) -> FrameBins:
    """Bin a frame group in one pass: every field of ``comps`` is (F, N).
    Returns what ``bin_frames`` returns for the F frames (each frame cut at
    its own ``max_dup``, compact and frame-major), with one host sync for
    the group: the F duplicate totals."""
    dev = comps.mx.device
    f, n = comps.mx.shape
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    num_tiles = tx_tiles * ty_tiles

    # 1. per-frame depth order (a batched stable sort: invalid splats last)
    key = torch.where(comps.valid, comps.depth, torch.full_like(comps.depth, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices  # (F, N) local splat ids

    def take(x):
        return torch.gather(x, 1, order)

    x0, y0, x1, y1 = tile_aabb(take(comps.mx), take(comps.my), take(comps.rx), take(comps.ry),
                               tile, tx_tiles, ty_tiles)
    spans_x = torch.clamp(x1 - x0, min=0)
    ntiles = torch.where(take(comps.valid), spans_x * torch.clamp(y1 - y0, min=0), 0)
    offs = torch.cumsum(ntiles, dim=-1)  # (F, N) inclusive per frame, int64
    starts = offs - ntiles
    totals = offs[:, -1] if n else torch.zeros(f, dtype=torch.int64, device=dev)
    totals_host = totals.tolist()  # the group's one host sync
    frame_dups = tuple(min(t, max_dup) for t in totals_host)
    d_count = sum(frame_dups)
    if d_count >= 2**31:
        raise ValueError(f"{d_count} duplicates in one frame group exceed int32 tile ranges")

    # 2. the kept duplicates, frame-major and in depth order within a frame
    kept = torch.clamp(totals, max=max_dup)[:, None]  # (F, 1), on the device
    first = torch.cumsum(kept, 0) - kept  # (F, 1) first kept duplicate of each frame
    seg_start = torch.clamp(starts, max=kept)
    seg_end = torch.clamp(offs, max=kept)
    slot = torch.repeat_interleave(torch.arange(f * n, device=dev),
                                   (seg_end - seg_start).reshape(-1), output_size=d_count)
    frame = slot // n
    local = torch.arange(d_count, device=dev) - (first + starts).reshape(-1)[slot]
    width_of = torch.clamp(spans_x.reshape(-1)[slot], min=1)
    tid = ((y0.reshape(-1)[slot] + local // width_of) * tx_tiles + x0.reshape(-1)[slot]
           + local % width_of + frame * num_tiles)

    # 3. one stable sort by (frame, tile): depth order survives in each
    tid_sorted, presort_pos = torch.sort(tid, stable=True)
    depth_order = (order + torch.arange(f, device=dev)[:, None] * n).reshape(-1)
    gather_idx = depth_order[slot[presort_pos]]

    # 4. per-(frame, tile) ranges
    tids = torch.arange(f * num_tiles, device=dev, dtype=tid_sorted.dtype)
    tile_start = torch.searchsorted(tid_sorted, tids, side="left").to(torch.int32)
    tile_end = torch.searchsorted(tid_sorted, tids, side="right").to(torch.int32)
    return FrameBins(gather_idx, tile_start, tile_end, max(totals_host, default=0), frame_dups,
                     presort_pos, (seg_start + first).reshape(-1),
                     (seg_end + first).reshape(-1), depth_order)
