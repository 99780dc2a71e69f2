"""E1's contract on the CPU: ``cuda_expand.expand_runs`` (its plain
version on CPU tensors) against the plain route of ``skm.expand_chunk``
and the JAX package's ``expand_chunk``, column for column, tolerance 0;
the wrapper's refusals; and the chunked finalize, whose padded run
columns E1 reads as rows of one buffer, against the single-shot one.
The kernel itself runs in ``tests/test_torch_cuda.py`` (marked cuda)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaarme_tpu.ops import skm as ref_skm
from kaarme_tpu_torch.ops import cuda_expand, skm
from kaarme_tpu_torch.ops.cuda_skm import EBITS, LMAX, content_words
from kaarme_tpu_torch.ops.sortcount import make_store
from kaarme_tpu_torch.utils import trace

from expand_rows import KS, run_rows

def _torch(cols):
    return tuple(torch.from_numpy(c) for c in cols)


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a).view(np.int32)
        b = np.asarray(b).view(np.int32)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("R", [0, 1, 33, 1001])
@pytest.mark.parametrize("k", KS)
def test_expand_runs_equals_plain_route(k, R):
    """R = 33 and 1001: no multiple of 32 runs nor of a 256-row block."""
    cols = _torch(run_rows(R, k, seed=k + R))
    got = cuda_expand.expand_runs(cols, k)
    want = skm.expand_chunk(cols, k, kernels="plain")
    assert len(got) == (k + 15) // 16 + 1
    assert all(c.dtype == torch.int32 and c.shape == (R * LMAX,) for c in got)
    _assert_same(got, want)
    _assert_same(skm.expand_chunk(cols, k, kernels="cuda"), want)


@pytest.mark.parametrize("k", KS)
def test_expand_runs_equals_jax_reference(k):
    """The JAX package's expansion on the same rows.  Its dead-run mask
    takes counts >= 0, which is what a run store holds: a negative count
    is held to the port's plain route alone (above)."""
    np_cols = run_rows(1001, k, seed=7 * k, negative=False)
    got = cuda_expand.expand_runs(_torch(np_cols), k)
    ref_cols = tuple(jnp.asarray(c.view(np.uint32)) for c in np_cols[:-1]) + \
        (jnp.asarray(np_cols[-1]),)
    want = ref_skm.expand_chunk(ref_cols, k=k)
    _assert_same(got, [np.asarray(w) for w in want])


def test_expand_runs_row_layout():
    """Row r * LMAX + e is window e of run r.  One run of 16 A then 16 C
    (content words 0, 0x55555555, 0) at k=17 with ell = 6: window e is
    16 - e A then e + 1 C, whose forward key (starting with A) is below
    its reverse complement (starting with G); rows past ell are
    sentinels with count 0, the others carry the run's count."""
    k, Wc = 17, content_words(17)
    cw = [0, 0x55555555] + [0] * (Wc - 2)
    cols = tuple(torch.tensor([np.uint32(w).view(np.int32)], dtype=torch.int32) for w in cw)
    meta = torch.tensor([np.uint32(5 << EBITS).view(np.int32)], dtype=torch.int32)
    keys = cuda_expand.expand_runs(cols + (meta, torch.tensor([9], dtype=torch.int32)), k)
    k0, k1, cnt = (c.numpy().view(np.uint32) for c in keys)
    assert cnt.tolist() == [9] * 6 + [0] * 10
    assert (k0[6:] == 0xFFFFFFFF).all() and (k1[6:] == 0xFFFFFFFF).all()
    for e in range(6):
        assert k0[e] == ((1 << (2 * e)) - 1) & 0x55555555   # 16 - e A, e C
        assert k1[e] == 1 << 30                             # C, masked to one base


def test_expand_runs_refusals():
    cols = _torch(run_rows(40, 51, seed=1))
    with pytest.raises(ValueError, match="int32"):
        cuda_expand.expand_runs(tuple(c.to(torch.int64) for c in cols), 51)
    with pytest.raises(ValueError, match="int32"):
        cuda_expand.expand_runs(cols[:-1] + (cols[-1].to(torch.int64),), 51)
    with pytest.raises(ValueError, match="run columns"):
        cuda_expand.expand_runs(cols[:-1], 51)
    with pytest.raises(ValueError, match="run columns"):
        cuda_expand.expand_runs(cols, 101)
    with pytest.raises(ValueError, match="one device"):
        cuda_expand.expand_runs(cols[:-1] + (torch.empty(40, dtype=torch.int32,
                                                         device="meta"),), 51)
    with pytest.raises(ValueError, match="one length"):
        cuda_expand.expand_runs(cols[:-1] + (cols[-1][:39],), 51)
    with pytest.raises(ValueError, match="k >= 16"):
        cuda_expand.expand_runs(_torch(run_rows(4, 15, seed=1)), 15)


@pytest.mark.parametrize("k", [16, 51, 201])
def test_chunked_finalize_equals_single_shot(k):
    """The chunked finalize (padded run columns as rows of one buffer,
    chunks of 64 runs into an accumulator that regrows) equals the
    single-shot one, through both routes of expand_chunk."""
    cols = _torch(run_rows(1001, k, seed=3 * k, negative=False))
    one, n1 = skm.finalize_store(cols, k, kernels="plain")
    for kernels in ("plain", "cuda"):
        stats = {}
        with trace.span("finalize", stats):
            many, n2 = skm.finalize_store(cols, k, chunk_rows=64, single_shot_rows=0,
                                          kernels=kernels)
        assert n2 == n1 > 0
        assert stats["finalize_regrows"] >= 1
        assert stats["finalize_chunks"] == -(-1001 // 64) + stats["finalize_regrows"]
        _assert_same([c[:n1] for c in many], [c[:n1] for c in one])
    empty, n0 = skm.finalize_store(tuple(c[:0] for c in cols), k)
    assert n0 == 0 and len(empty) == len(make_store(0, (k + 15) // 16, "cpu"))
