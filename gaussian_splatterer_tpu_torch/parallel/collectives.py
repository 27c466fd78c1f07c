"""The collectives of the sharded steps, each the counterpart of one JAX
collective over a mesh axis:

    psum                      -> all_reduce_sum (one flat buffer)
    pmax                      -> all_reduce_max
    all_gather(tiled=True)    -> all_gather_rows (all_gather_into_tensor)
    psum_scatter(tiled=True)  -> reduce_scatter_rows (reduce_scatter_tensor)
    all_to_all                -> all_to_all_rows (all_to_all_single, uneven)

``all_to_all_rows`` moves a different number of rows to each rank: JAX's
all_to_all exchanges equal blocks only, which is why the JAX package routes
records through fixed-capacity buckets (parallel/route.py).

Every call takes the process group of its axis (``DeviceMesh.get_group``)
and a ``CommStats`` that counts its calls and payload bytes and, when
``timed``, its seconds.

gloo reduces CUDA tensors in its all-reduce only; its all-gather,
reduce-scatter and all-to-all take CPU tensors.  So under gloo a CUDA
tensor is staged through host memory: copied to the host, reduced there
and copied back (``_staged``).  This is for gloo with CUDA tensors alone, which is how two
ranks share one card (NCCL refuses two ranks on one GPU); under nccl every
collective runs on the device.
"""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist


@dataclass
class CommStats:
    """What a step's collectives cost on this rank: calls, payload bytes
    (each call's input tensor) and, when ``timed``, the host seconds around
    each call with the device synchronised before and after it."""

    timed: bool = False
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def _no_deprecation_warning():
    """Newer torch calls all_gather_into_tensor and reduce_scatter_tensor
    deprecated in favour of *_single calls that older releases lack; both
    releases have these two."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", r"`torch\.distributed\.(all_gather_into_tensor|"
                                r"reduce_scatter_tensor)` is deprecated", FutureWarning)
        yield


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(stats: CommStats | None, t: torch.Tensor, fn) -> torch.Tensor:
    if stats is None:
        return fn()
    stats.calls += 1
    stats.bytes += t.numel() * t.element_size()
    if not stats.timed:
        return fn()
    _sync(t)
    t0 = time.perf_counter()
    out = fn()
    _sync(out)
    stats.seconds += time.perf_counter() - t0
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group,
                   stats: CommStats | None = None) -> list[torch.Tensor]:
    """The sums over the group of every tensor (float32, one device), in one
    all-reduce of a flat buffer holding them all; new tensors of the same
    shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])

    def reduce():
        buf = flat.cpu() if _staged(flat, group) else flat
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(flat.device)

    out = _run(stats, flat, reduce)
    return [x.view_as(t) for x, t in zip(torch.split(out, [t.numel() for t in tensors]),
                                         tensors)]


def all_reduce_max(value: int, group, device, stats: CommStats | None = None) -> int:
    """The largest ``value`` over the group (the step's num_dup)."""
    return all_reduce_max_ints([value], group, device, stats)[0]


def all_reduce_max_ints(values: Sequence[int], group, device,
                        stats: CommStats | None = None) -> list[int]:
    """The largest of each of ``values`` over the group, in one all-reduce."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)

    def reduce():
        buf = t.cpu() if _staged(t, group) else t
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        return buf

    return _run(stats, t, reduce).tolist()


def all_gather_rows(x: torch.Tensor, group, stats: CommStats | None = None) -> torch.Tensor:
    """Every rank's ``x`` (R, ...) stacked along rows in rank order, (n R, ...)."""
    n = dist.get_world_size(group)

    def gather():
        src = x.contiguous()
        if _staged(src, group):
            src = src.cpu()
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        with _no_deprecation_warning():
            dist.all_gather_into_tensor(out, src, group=group)
        return out.to(x.device)

    return _run(stats, x, gather)


def reduce_scatter_rows(x: torch.Tensor, group, stats: CommStats | None = None) -> torch.Tensor:
    """Sum ``x`` (n R, ...) over the group and keep this rank's R rows of
    the sum."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")

    def scatter():
        src = x.contiguous()
        if _staged(src, group):
            src = src.cpu()
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        with _no_deprecation_warning():
            dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
        return out.to(x.device)

    return _run(stats, x, scatter)


def all_to_all_rows(x: torch.Tensor, send_counts: Sequence[int], group,
                    stats: CommStats | None = None,
                    recv_counts: Sequence[int] | None = None) -> tuple[torch.Tensor, list[int]]:
    """Rows of ``x`` (L, ...), grouped by destination in group-rank order
    (the first send_counts[0] rows to rank 0, the next send_counts[1] to
    rank 1, ...) -> (the rows every rank sent this one, sources in rank
    order, each source's rows in its order; how many came from each).

    One all_to_all_single of the (n,) int64 counts, then one of the rows
    with uneven splits.  A caller that knows ``recv_counts`` (the way back
    of an exchange: its split sizes swapped) passes them and skips the
    first.  Both calls count in ``stats``."""
    n = dist.get_world_size(group)
    send_counts = [int(c) for c in send_counts]
    if len(send_counts) != n or sum(send_counts) != x.shape[0]:
        raise ValueError(f"send counts {send_counts} do not split {x.shape[0]} rows over "
                         f"{n} ranks")
    staged = _staged(x, group)
    if recv_counts is None:
        send = torch.tensor(send_counts, dtype=torch.int64,
                            device="cpu" if staged else x.device)

        def exchange_counts():
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=group)
            return recv

        recv_counts = _run(stats, send, exchange_counts).tolist()
    recv_counts = [int(c) for c in recv_counts]

    def exchange_rows():
        src = x.contiguous()
        if staged:
            src = src.cpu()
        out = torch.empty((sum(recv_counts), *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_to_all_single(out, src, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts, group=group)
        return out.to(x.device)

    return _run(stats, x, exchange_rows), recv_counts


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank of the default group (a pickled
    object; the ranks are this program's own processes)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
