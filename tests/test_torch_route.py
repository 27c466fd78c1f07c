"""PyTorch port vs JAX package: record routing (parallel/route.py).

``bucket_local`` and ``unbucket_local`` are local permutations, held bit
for bit against JAX's on seeded records, with caps that drop records and
destinations out of range.  The exact exchange (``bucket_route``,
``route_back``, on collectives.all_to_all_rows) runs in
tests/torch_parallel_runner.py's ``route`` suite over 4 gloo ranks, on
tests/test_route.py's records (payload row 0 = source x 1000 + local index)
with every 7th record sent out of range: every in-range record arrives
exactly once, in its sender's order, sources in rank order (JAX's
``recv[s]`` when nothing overflows), also when half of every rank's
records go to one rank; route_back returns each value to its record.  Rows
sent from two slots each (the routed step's band slots) arrive once a
record and come back summed over their slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_runner as runner
from test_torch_parallel_bands import _world

from gaussian_splatterer_tpu_torch.parallel import bucket_local, unbucket_local

S = runner.WORLDS["route"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The runner's ``route`` suite at world 4."""
    return _world(tmp_path_factory, "route")


def _local_records(seed, l=37, k=3, n_dst=5):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, n_dst + 1, l).astype(np.int32)  # -1 and n_dst drop
    return dst, rng.normal(size=(k, l)).astype(np.float32), n_dst


@pytest.mark.parametrize("cap", [16, 4, 2, 1])
@pytest.mark.parametrize("seed", [7, 8])
def test_bucket_local_matches_jax(seed, cap):
    """Buckets, valid slots and max_count equal JAX's bit for bit, caps that
    drop included; unbucket_local of the buckets equals JAX's too."""
    from gaussian_splatterer_tpu.parallel.route import bucket_local as j_bucket
    from gaussian_splatterer_tpu.parallel.route import unbucket_local as j_unbucket

    dst, payload, n_dst = _local_records(seed)
    b_t, v_t, mc_t = bucket_local(torch.from_numpy(dst), torch.from_numpy(payload), n_dst, cap)
    b_j, v_j, mc_j = j_bucket(jnp.asarray(dst), jnp.asarray(payload), n_dst, cap)
    assert b_t.shape == (n_dst, 3, cap)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert int(mc_t) == int(mc_j)
    back_t = unbucket_local(torch.from_numpy(dst), b_t, cap)
    np.testing.assert_array_equal(back_t.numpy(),
                                  np.asarray(j_unbucket(jnp.asarray(dst), b_j, cap)))


@pytest.mark.parametrize("cap", [4, 2])
def test_unbucket_inverts_bucket_local(cap):
    """tests/test_route.py's round trip: kept records come back, dropped ones
    (destination out of range, past the cap) as zeros; unbucketing other
    slot values equals JAX's."""
    from gaussian_splatterer_tpu.parallel.route import unbucket_local as j_unbucket

    dst, payload, n_dst = _local_records(7)
    buckets, _, mc = bucket_local(torch.from_numpy(dst), torch.from_numpy(payload), n_dst, cap)
    assert int(mc) > cap
    back = unbucket_local(torch.from_numpy(dst), buckets, cap).numpy()
    kept = np.zeros(dst.size, bool)
    counts = dict.fromkeys(range(n_dst), 0)
    for j, d in enumerate(dst):
        if 0 <= d < n_dst:
            kept[j] = counts[d] < cap
            counts[d] += 1
    np.testing.assert_array_equal(back, np.where(kept[None, :], payload, 0.0))
    slots = np.random.default_rng(3).normal(size=(n_dst, 3, cap)).astype(np.float32)
    np.testing.assert_array_equal(
        unbucket_local(torch.from_numpy(dst), torch.from_numpy(slots), cap).numpy(),
        np.asarray(j_unbucket(jnp.asarray(dst), jnp.asarray(slots), cap)))


def test_bucket_local_drops_out_of_range():
    """tests/test_route.py's case: destinations -1 and 5 of 3 are dropped."""
    dst = torch.tensor([0, 1, -1, 5, 1, 2])
    payload = torch.arange(6, dtype=torch.float32)[None, :]
    buckets, valid, mc = bucket_local(dst, payload, n_dst=3, cap=4)
    assert int(mc) == 2
    assert sorted(buckets[:, 0][valid].tolist()) == [0.0, 1.0, 4.0, 5.0]
    empty, valid0, mc0 = bucket_local(torch.zeros(0, dtype=torch.int64),
                                      torch.zeros((2, 0)), n_dst=3, cap=2)
    assert empty.shape == (3, 2, 2) and not valid0.any() and int(mc0) == 0


def _want(dst, payload, d):
    """(the records rank d must receive, in order: sources in rank order,
    each source's in its order; how many from each source)."""
    rows, counts = [], []
    for s in range(S):
        js = [j for j in range(runner.ROUTE_L) if dst[s, j] == d]
        rows += [payload[s, :, j] for j in js]
        counts.append(len(js))
    return np.array(rows, np.float32).reshape(-1, runner.ROUTE_K), counts


@pytest.mark.parametrize("case,seed,skew", [("exact", 0, None), ("skew", 1, 3)])
def test_every_record_routes_exactly_once(world, case, seed, skew):
    """Every in-range record arrives once at its destination with its whole
    payload, in the sender's order, sources in rank order; out-of-range
    ones nowhere.  max_count is the most one rank sent one destination; the
    skewed case sends half of every rank's records to rank 3, which a
    quarter-size JAX bucket would have dropped."""
    ranks = world(f"route_{case}")
    dst, payload = runner.route_records(seed, skew)
    for d, got in enumerate(ranks):
        rows, counts = _want(dst, payload, d)
        assert got["counts"].tolist() == counts
        np.testing.assert_array_equal(got["recv"], rows)
        ids = got["recv"][:, 0].astype(int)
        assert [i // 1000 for i in ids] == sorted(i // 1000 for i in ids)
    sent = sum(len(r["recv"]) for r in ranks)
    assert sent == int(((dst >= 0) & (dst < S)).sum()) < dst.size
    for s, got in enumerate(ranks):
        assert int(got["max_count"]) == max(int((dst[s] == d).sum()) for d in range(S))
        assert int(got["calls"]) == 2  # the counts, then the rows
    if skew is not None:
        assert len(ranks[skew]["recv"]) >= S * runner.ROUTE_L // 2
        assert [int(r["max_count"]) for r in ranks] == [int((dst[s] == skew).sum())
                                                         for s in range(S)]


def test_route_back_returns_to_sender(world):
    """The receiver doubles what it got and route_back returns it: each
    sender gets 2 x its payload at its records' places, zeros for the
    records it did not send; one more exchange, of the rows alone."""
    ranks = world("route_back")
    dst, payload = runner.route_records(3)
    for s, got in enumerate(ranks):
        kept = (dst[s] >= 0) & (dst[s] < S)
        want = np.where(kept[:, None], payload[s].T * 2.0, 0.0)
        np.testing.assert_array_equal(got["back"], want)
        assert int(got["calls"]) == 3
        rows = int(kept.sum()) + len(got["recv"])
        assert int(got["bytes"]) == S * 8 + rows * runner.ROUTE_K * 4


def test_slot_records_route_and_sum_back(world):
    """dst (S, 2, L): row j goes to dst[s, 0, j] and to dst[s, 1, j]; the
    receiver gets the records in (slot, row) order, sources in rank order,
    and route_back returns each row 2 x its payload once a slot sent
    (zeros where neither was), one exchange of counts and two of rows."""
    ranks = world("route_slots")
    dst, payload = runner.route_slots()
    for d, got in enumerate(ranks):
        rows, counts = [], []
        for s in range(S):
            recs = [(b, j) for b in range(dst.shape[1]) for j in range(runner.ROUTE_L)
                    if dst[s, b, j] == d]
            rows += [payload[s, :, j] for _, j in recs]
            counts.append(len(recs))
        assert got["counts"].tolist() == counts
        np.testing.assert_array_equal(got["recv"], np.array(rows, np.float32))
    for s, got in enumerate(ranks):
        kept = ((dst[s] >= 0) & (dst[s] < S)).sum(0)
        assert 0 in kept and 2 in kept
        np.testing.assert_array_equal(got["back"], payload[s].T * 2.0 * kept[:, None])
        assert int(got["max_count"]) == max(int((dst[s] == d).sum()) for d in range(S))
        assert int(got["calls"]) == 3
        rows = int(kept.sum()) + len(got["recv"])
        assert int(got["bytes"]) == S * 8 + rows * runner.ROUTE_K * 4
