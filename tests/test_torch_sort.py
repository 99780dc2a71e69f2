"""``sortcount.lexsort`` of the PyTorch port — the multi-word
lexicographic sort that ``jax.lax.sort(num_keys=...)`` gave the JAX
package — against ``np.lexsort`` and ``jax.lax.sort`` on int32
bit-pattern columns with the sign bit set, duplicates and sentinels."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaarme_tpu_torch.ops import sortcount


def _cols(ncols, n, seed):
    rng = np.random.default_rng(seed)
    # few distinct values per column: many ties that later columns break
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                    np.uint32)
    cols = [vals[rng.integers(0, vals.shape[0], n)] for _ in range(ncols)]
    cols[0][:5] = 0xFFFFFFFF                         # sentinel rows must sort last
    for c in cols:
        c[5:9] = 0xFFFFFFFF
    return cols


def _torch(cols):
    return [torch.from_numpy(c.view(np.int32)) for c in cols]


@pytest.mark.parametrize("ncols", [1, 2, 3, 4, 5, 6, 7])
def test_lexsort_matches_numpy_and_lax(ncols):
    cols = _cols(ncols, 3000, seed=ncols)
    got = sortcount.lexsort(_torch(cols), num_keys=ncols).numpy().view(np.uint32)
    order = np.lexsort(tuple(cols[::-1]))
    np.testing.assert_array_equal(got, np.stack([c[order] for c in cols]))
    ref = jax.lax.sort(tuple(jnp.asarray(c) for c in cols), num_keys=ncols)
    np.testing.assert_array_equal(got, np.stack([np.asarray(r) for r in ref]))
    assert (got[:, -4:] == 0xFFFFFFFF).all()         # all-ones rows sort last


@pytest.mark.parametrize("num_keys", [2, 3])
def test_lexsort_is_stable_with_payload(num_keys):
    """Rows with equal keys keep their input order (the payload column
    is a row id and rides along unsorted)."""
    cols = _cols(num_keys, 5000, seed=40 + num_keys)
    rowid = np.arange(5000, dtype=np.uint32)
    got = sortcount.lexsort(_torch(cols + [rowid]), num_keys=num_keys).numpy()
    order = np.lexsort(tuple(cols[::-1]))            # np.lexsort is stable
    np.testing.assert_array_equal(got[-1].view(np.uint32), rowid[order])


def test_lexsort_empty():
    out = sortcount.lexsort(_torch([np.zeros(0, np.uint32)] * 3), num_keys=3)
    assert out.shape == (3, 0)
