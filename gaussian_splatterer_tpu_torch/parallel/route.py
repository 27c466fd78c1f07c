"""Data-dependent record routing between ranks (counterpart of
gaussian_splatterer_tpu.parallel.route).

The routed 3-axis step (parallel/routed3.py) sends each projected (frame,
splat) record from the rank that projects it to the ranks that composite
it, and the records' gradients back.  JAX's all_to_all exchanges equal
blocks only, so the JAX package packs records into fixed-capacity
per-destination buckets, drops what overflows and reports it.
torch.distributed's all_to_all_single takes uneven splits, so here the
exchange is exact (collectives.all_to_all_rows):

  * ``bucket_route`` sorts the records stably by destination and sends
    each rank its run; nothing is dropped but records whose destination
    is out of range.  The receiver gets each source's records in the
    source's order, sources in rank order: the order of JAX's ``recv[s]``
    when nothing overflows.
  * ``route_back`` is the inverse exchange (the split sizes swapped) and
    puts each returned value at its record's place; records that were
    not sent get zeros.

Payloads are rows, (L, K), so that the exchange splits along dim 0.  A row
may stand for several records: with ``dst`` (B, L), record (b, i) carries
row i to rank dst[b, i] (the routed step's band slots), the row is read
once a record sent and never copied B times, and route_back sums a row's
returned values over its slots, in slot order.
``bucket_local`` and ``unbucket_local`` keep JAX's local contract (a fixed
``cap``, stable order within a destination, drops reported through
``max_count``) and equal JAX's bit for bit; the routed step re-buckets its
received records by frame with them, at a capacity that drops nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gaussian_splatterer_tpu_torch.parallel.collectives import CommStats, all_to_all_rows


def _sorted_keys(dst: torch.Tensor, n_dst: int):
    """(keys sorted stably, the permutation): a record's key is its
    destination, or n_dst when that is out of range (the dropped, last)."""
    in_range = (dst >= 0) & (dst < n_dst)
    key = torch.where(in_range, dst.to(torch.int64), n_dst)
    return torch.sort(key, stable=True)


def _run_starts(skey: torch.Tensor, n_dst: int) -> torch.Tensor:
    """(n_dst + 1,) int64: the sorted position where each destination's run
    starts, and the end of the last."""
    bounds = torch.arange(n_dst + 1, dtype=torch.int64, device=skey.device)
    return torch.searchsorted(skey, bounds, side="left")


def bucket_local(dst: torch.Tensor, payload: torch.Tensor, n_dst: int, cap: int):
    """Pack local records into (n_dst, cap) fixed buckets.

    dst: (L,) destination in [0, n_dst) (any other value drops the
    record).  payload: (K, L) float rows.  Returns (buckets (n_dst, K,
    cap), valid (n_dst, cap), max_count (0-d int64)): records beyond ``cap``
    for a destination are dropped and reported by max_count (> cap means
    overflow).  Records keep their local order within a bucket."""
    k, l = payload.shape
    dev = payload.device
    skey, order = _sorted_keys(dst, n_dst)
    below = _run_starts(skey, n_dst)
    offsets, counts = below[:-1], below[1:] - below[:-1]
    ii = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    valid = ii < torch.clamp(counts, max=cap)[:, None]
    if l == 0:
        buckets = torch.zeros((n_dst, k, cap), dtype=payload.dtype, device=dev)
    else:
        rec = torch.clamp(offsets[:, None] + ii, 0, l - 1).reshape(-1)
        buckets = payload[:, order][:, rec].reshape(k, n_dst, cap).transpose(0, 1)
        buckets = torch.where(valid[:, None, :], buckets, torch.zeros((), dtype=payload.dtype,
                                                                      device=dev))
    return buckets, valid, counts.max()


def unbucket_local(dst: torch.Tensor, buckets: torch.Tensor, cap: int) -> torch.Tensor:
    """Inverse of bucket_local's packing: per-slot values (n_dst, K, cap) ->
    per-record values (K, L) in the records' original order.

    ``dst`` must be the destinations bucket_local saw (the permutation is
    recomputed, not stored).  Records that it dropped (out-of-range
    destination, bucket overflow) get zeros."""
    n_dst, k, _ = buckets.shape
    l = dst.shape[0]
    skey, order = _sorted_keys(dst, n_dst)
    starts = _run_starts(skey, n_dst)
    run = torch.clamp(skey, max=n_dst - 1)
    rank = torch.arange(l, dtype=torch.int64, device=dst.device) - torch.where(
        skey < n_dst, starts[run], 0)
    ok = (skey < n_dst) & (rank < cap)
    flat = run * cap + torch.clamp(rank, 0, cap - 1)
    bk = buckets.transpose(0, 1).reshape(k, n_dst * cap)
    g_sorted = torch.where(ok[None, :], bk[:, flat], torch.zeros((), dtype=buckets.dtype,
                                                                 device=buckets.device))
    out = torch.empty_like(g_sorted)
    out[:, order] = g_sorted  # sorted position p holds record order[p]
    return out


def _route_plan(dst: torch.Tensor, group):
    """(the sent records' flat indices into ``dst``, sorted by destination;
    how many go to each rank of ``group``)."""
    n = dist.get_world_size(group)
    skey, order = _sorted_keys(dst.reshape(-1), n)
    counts = torch.bincount(skey, minlength=n + 1)[:n].tolist()
    return order[:sum(counts)], counts


def bucket_route(dst: torch.Tensor, payload: torch.Tensor, group,
                 stats: CommStats | None = None):
    """Send each local record to its rank of ``group``, exactly.

    ``payload`` (L, K) holds a row a record and ``dst`` (L,) its rank; or
    ``dst`` (B, L) gives each row B records, record (b, i) carrying row i
    to rank dst[b, i], records in flat (slot-major) order.  Returns (recv
    (R, K): the records this rank received, sources in rank order, each
    source's in its order; recv_counts: how many came from each rank;
    max_count: the largest number this rank sent to one rank).  Records
    whose destination is out of range are not sent."""
    sent, counts = _route_plan(dst, group)
    recv, recv_counts = all_to_all_rows(payload[sent % payload.shape[0]], counts, group, stats)
    return recv, recv_counts, max(counts, default=0)


def route_back(dst: torch.Tensor, values: torch.Tensor, recv_counts, group,
               stats: CommStats | None = None) -> torch.Tensor:
    """Return per-record values to their senders: the inverse exchange of
    bucket_route(dst, ...) on ``group``.

    ``values`` (R, K) are laid out like bucket_route's ``recv`` on the
    receiver, ``recv_counts`` the counts it returned.  The sender gets (L,
    K) rows aligned with its payload rows: for ``dst`` (B, L), the sum of
    a row's returned values over its slots, added in slot order; zeros for
    rows of which no record was sent."""
    sent, counts = _route_plan(dst, group)
    back, _ = all_to_all_rows(values, recv_counts, group, stats, recv_counts=counts)
    l = dst.shape[-1]
    out = torch.zeros((l, *values.shape[1:]), dtype=values.dtype, device=values.device)
    if dst.dim() == 1:
        out[sent] = back
        return out
    rows, slot = sent % l, torch.div(sent, l, rounding_mode="floor")
    by_slot = torch.sort(slot, stable=True).indices
    for idx in torch.split(by_slot, torch.bincount(slot, minlength=dst.shape[0]).tolist()):
        out.index_add_(0, rows[idx], back[idx])  # a row once a slot: no two adds meet
    return out
