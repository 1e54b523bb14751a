"""The sparse-row update applier (``ops/apply.py``) against a numpy
oracle: per-row capped gradient sums, two-stream merging, padding,
edge ids, and bit-for-bit repeatability.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from pecanpy_tpu.ops.apply import (
    apply_mean_updates,
    apply_mean_updates_two,
)


def reference(table, ids, upd, cnt, lr, cap):
    sums = np.zeros_like(table)
    cnts = np.zeros(table.shape[0])
    for i, u, c in zip(ids, upd, cnt):
        sums[i] += u
        cnts[i] += c
    scale = np.minimum(cnts, cap) / np.maximum(cnts, 1e-9)
    return table - lr * sums * scale[:, None]


@pytest.mark.parametrize("cap", [1.0, 4.0])
def test_matches_reference(rng, cap):
    n, d, r = 50, 16, 200
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, r).astype(np.int32)
    upd = rng.normal(size=(r, d)).astype(np.float32)
    cnt = rng.integers(0, 3, r).astype(np.float32)
    got = apply_mean_updates(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd),
        jnp.asarray(cnt), jnp.float32(0.05), cap=cap,
    )
    expected = reference(table, ids, upd, cnt, 0.05, cap)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=2e-5, atol=1e-6)


def test_two_streams_equal_sequential(rng):
    """Merged two-stream application == applying the streams one by one
    (linearity of the pre-scaled form; groups keep separate caps)."""
    n, d = 40, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    r_a, r_b = 90, 30
    ids_a = rng.integers(0, n, r_a).astype(np.int32)
    upd_a = rng.normal(size=(r_a, d)).astype(np.float32)
    cnt_a = rng.integers(0, 3, r_a).astype(np.float32)
    ids_b = rng.integers(0, n, r_b).astype(np.int32)
    upd_b = rng.normal(size=(r_b, d)).astype(np.float32)
    cnt_b = rng.integers(0, 3, r_b).astype(np.float32)
    lr = jnp.float32(0.05)
    got = apply_mean_updates_two(
        jnp.asarray(table), jnp.asarray(ids_a), jnp.asarray(upd_a),
        jnp.asarray(cnt_a), jnp.asarray(ids_b), jnp.asarray(upd_b),
        jnp.asarray(cnt_b), lr, cap_a=4.0, cap_b=1.0,
    )
    step1 = apply_mean_updates(
        jnp.asarray(table), jnp.asarray(ids_a), jnp.asarray(upd_a),
        jnp.asarray(cnt_a), lr, cap=4.0,
    )
    expected = apply_mean_updates(
        step1, jnp.asarray(ids_b), jnp.asarray(upd_b),
        jnp.asarray(cnt_b), lr, cap=1.0,
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), rtol=2e-5, atol=1e-6
    )


def test_untouched_rows_unchanged(rng):
    n, d = 32, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = jnp.asarray([3, 3, 7], dtype=jnp.int32)
    upd = jnp.asarray(rng.normal(size=(3, d)).astype(np.float32))
    cnt = jnp.ones(3)
    got = np.asarray(
        apply_mean_updates(jnp.asarray(table), ids, upd, cnt, jnp.float32(0.1))
    )
    mask = np.ones(n, bool)
    mask[[3, 7]] = False
    np.testing.assert_array_equal(got[mask], table[mask])
    assert not np.allclose(got[3], table[3])


def test_zero_count_padding_is_noop(rng):
    n, d = 16, 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = jnp.asarray([5, 9], dtype=jnp.int32)
    upd = jnp.zeros((2, d))
    cnt = jnp.zeros(2)
    got = np.asarray(
        apply_mean_updates(jnp.asarray(table), ids, upd, cnt, jnp.float32(0.1))
    )
    np.testing.assert_array_equal(got, table)


def _stream(rng, n, r, d, ids=None):
    if ids is None:
        ids = rng.integers(0, n, r)
    return (
        np.asarray(ids, dtype=np.int32),
        rng.normal(size=(r, d)).astype(np.float32),
        rng.integers(0, 4, r).astype(np.float32),
    )


def _case(name, rng):
    """(table, stream a, stream b or None, cap_a, cap_b) for one case."""
    n, d = 64, 16
    table = rng.normal(size=(n, d)).astype(np.float32)
    if name == "one_cap1":
        return table, _stream(rng, n, 300, d), None, 1.0, 1.0
    if name == "one_cap20":
        return table, _stream(rng, n, 300, d), None, 20.0, 20.0
    if name == "two_caps_4_1":
        return table, _stream(rng, n, 200, d), _stream(rng, n, 90, d), 4.0, 1.0
    if name == "two_cap20":
        return (table, _stream(rng, n, 200, d), _stream(rng, n, 90, d),
                20.0, 20.0)
    if name == "empty_one":
        return table, _stream(rng, n, 0, d), None, 4.0, 4.0
    if name == "empty_two":
        return table, _stream(rng, n, 0, d), _stream(rng, n, 0, d), 4.0, 4.0
    if name == "hot_row_one":
        return table, _stream(rng, n, 500, d, ids=np.full(500, 9)), None, 4.0, 4.0
    if name == "hot_row_two":
        return (table, _stream(rng, n, 300, d, ids=np.full(300, 9)),
                _stream(rng, n, 200, d, ids=np.full(200, 9)), 4.0, 2.0)
    if name == "first_last_ids":
        ids = np.tile([0, n - 1], 40)
        return (table, _stream(rng, n, 80, d, ids=ids),
                _stream(rng, n, 80, d, ids=ids[::-1]), 4.0, 4.0)
    raise ValueError(name)


def _run(table, a, b, lr, cap_a, cap_b):
    j = [jnp.asarray(x) for x in a]
    if b is None:
        return np.asarray(apply_mean_updates(
            jnp.asarray(table), *j, jnp.float32(lr), cap=cap_a
        ))
    k = [jnp.asarray(x) for x in b]
    return np.asarray(apply_mean_updates_two(
        jnp.asarray(table), *j, *k, jnp.float32(lr), cap_a=cap_a, cap_b=cap_b
    ))


CASES = ["one_cap1", "one_cap20", "two_caps_4_1", "two_cap20", "empty_one",
         "empty_two", "hot_row_one", "hot_row_two", "first_last_ids"]


@pytest.mark.parametrize("name", CASES)
def test_applier_matches_numpy_oracle(rng, name):
    """Each stream keeps its own normalization group: the merged
    application equals the oracle applied stream by stream."""
    table, a, b, cap_a, cap_b = _case(name, rng)
    expected = reference(table, *a, 0.05, cap_a)
    if b is not None:
        expected = reference(expected, *b, 0.05, cap_b)
    got = _run(table, a, b, 0.05, cap_a, cap_b)
    np.testing.assert_allclose(got, expected, rtol=2e-5, atol=1e-6)
    if a[0].size == 0 and (b is None or b[0].size == 0):
        np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("name", ["two_cap20", "hot_row_two"])
def test_applier_repeat_calls_bit_identical(rng, name):
    """The segmented-scan reduction has a fixed order: repeated calls on
    the same inputs give the same bits."""
    table, a, b, cap_a, cap_b = _case(name, rng)
    first = _run(table, a, b, 0.05, cap_a, cap_b)
    for _ in range(3):
        np.testing.assert_array_equal(
            _run(table, a, b, 0.05, cap_a, cap_b), first
        )
