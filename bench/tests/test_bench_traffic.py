"""The traffic generator is deterministic per seed and sends the same
amount of work whatever the seed."""
import numpy as np

from bench.harness import traffic


def test_closed_order_is_a_permutation_cycled_in_batches():
    order = traffic.query_order(1000, 2**31 + 3)
    assert np.array_equal(np.sort(order), np.arange(1000))
    assert np.array_equal(order, traffic.query_order(1000, 2**31 + 3))
    seen = np.concatenate([traffic.closed_batch(order, 512, i) for i in range(4)])
    assert np.array_equal(seen[:1000], order)
    assert np.array_equal(seen[1000:2000], order[:1000])


def test_deletes_are_distinct_seeded_rows():
    mix = {"delete_frozen": 600}
    rows = traffic.deleted_rows(mix, 60000, 2**31 + 1)
    assert rows.shape == (600,) and np.unique(rows).size == 600
    assert np.array_equal(rows, traffic.deleted_rows(mix, 60000, 2**31 + 1))
    assert traffic.deleted_rows({}, 60000, 1).size == 0


def test_reinserted_rows_are_the_deleted_ones_alive_under_new_ids():
    import torch

    from bench.harness.system import truth

    data = type("D", (), {"corpus": torch.arange(20.0).reshape(10, 2), "n_train": 10})
    mix = {"delete_frozen": 3, "reinsert_deleted": True}
    deleted, rows, alive = truth(mix, data, 2**31 + 9)
    assert deleted.shape == (3,) and rows.shape == (13, 2)
    assert torch.equal(rows[10:], data.corpus[torch.as_tensor(deleted)])
    assert not alive[torch.as_tensor(deleted)].any() and alive[10:].all()
    assert int(alive.sum()) == 10
    _, rows, alive = truth({"delete_frozen": 3}, data, 2**31 + 9)
    assert rows.shape == (10, 2) and int(alive.sum()) == 7
