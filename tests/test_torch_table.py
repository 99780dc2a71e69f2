"""The probe table of the PyTorch port (``ops/table.py``; T1's plain
version, ``ops/cuda_table.table_insert_plain``, which T1's wrapper runs
on CPU tensors) held to ``kaarme_tpu.ops.table``: insert and lookup give
the same occupied (key row, count) multisets and the same pending sets
from the same table, duplicates within a batch accumulate, ``amount``
adds, absent keys read 0; overfull tables keep their invariants (stored
+ pending == input per key, no key in two slots, every stored key found
by lookup, occupancy == distinct keys); one writer per claimed slot (no
torn rows); tables carry over between the packages.  Every quantity is
an integer: tolerance 0."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.models import tiling as ref_tiling
from kaarme_tpu.ops import table as ref_table
from kaarme_tpu.ops.hashing import hash_words as ref_hash
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.models import sort_counter
from kaarme_tpu_torch.ops import cuda_table, table, windows
from kaarme_tpu_torch.ops.hashing import hash_words
from kaarme_tpu_torch.utils import convert


def _kmers(n, k, seed):
    rng = np.random.default_rng(seed)
    return [codec.canonical("".join("ACGT"[c] for c in rng.integers(0, 4, k))) for _ in range(n)]


def _packed(kmers):
    return np.stack([codec.pack_kmer(s) for s in kmers])          # (N, W) uint32


def _port_keys(packed):
    return tuple(torch.from_numpy(packed[:, w].astype(np.int64)) for w in range(packed.shape[1]))


def _ref_keys(packed):
    return tuple(jnp.asarray(packed[:, w]) for w in range(packed.shape[1]))


def _multiset(tk, cn):
    """Sorted (key row..., count) tuples of the occupied slots."""
    tk, cn = np.asarray(tk).view(np.uint32), np.asarray(cn)
    occ = cn > 0
    return sorted(zip(map(tuple, tk[occ].tolist()), cn[occ].tolist()))


def _both_inserts(cap_log2, packed, valid, amount=None, max_probes=64, start=None):
    """The JAX insert and the port's (both kernels values) from the same
    table; returns (ref (tk, cn, pending), [port (tk, cn, pending)...])."""
    W = packed.shape[1]
    if start is None:
        start = ref_table.make_table(cap_log2, W)
    rk = _ref_keys(packed)
    ramt = None if amount is None else jnp.asarray(amount)
    ref = ref_table.insert(*start, rk, jnp.asarray(valid), ref_hash(rk), ramt,
                           max_probes=max_probes)
    ports = []
    for kernels in ("cuda", "plain"):
        tk, cn = convert.table_to_torch(*start, "cpu")
        pk = _port_keys(packed)
        pamt = None if amount is None else torch.from_numpy(amount)
        tk, cn, pending, n_pending = table.insert(tk, cn, pk, torch.from_numpy(valid),
                                                  hash_words(pk), pamt, max_probes=max_probes,
                                                  kernels=kernels)
        assert int(n_pending) == int(pending.sum())
        ports.append((tk, cn, pending))
    return ref, ports


def test_make_table():
    tk, cn = table.make_table(10, 3, "cpu")
    assert tk.shape == (1024, 3) and tk.dtype == torch.int32 and not tk.any()
    assert cn.shape == (1024,) and cn.dtype == torch.int32 and not cn.any()


def test_tri_is_a_full_cycle():
    i = torch.arange(1 << 10, dtype=torch.int64)
    slots = (12345 + cuda_table._tri(i)) & ((1 << 10) - 1)
    assert slots.unique().numel() == 1 << 10
    big = torch.tensor([0, 1, 2, 3, 92681, 92682, (1 << 32) - 1])
    want = [(int(x) * (int(x) + 1)) % (1 << 32) >> 1 for x in big]
    assert cuda_table._tri(big).tolist() == want


@pytest.mark.parametrize("k", [7, 31, 51])
def test_insert_and_lookup_match_reference(k):
    kmers = sorted(set(_kmers(300, k, seed=k)))
    packed = _packed(kmers)
    valid = np.ones(len(kmers), bool)
    valid[::7] = False
    ref, ports = _both_inserts(10, packed, valid)
    want = _multiset(ref[0], ref[1])
    assert len(want) == int(valid.sum())
    for tk, cn, pending in ports:
        assert _multiset(tk.numpy(), cn.numpy()) == want
        assert not pending.any() and not np.asarray(ref[2]).any()
        pk = _port_keys(packed)
        got = table.lookup(tk, cn, pk, hash_words(pk))
        rk = _ref_keys(packed)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref_table.lookup(*ref[:2], rk, ref_hash(rk))))
        np.testing.assert_array_equal(got.numpy(), valid.astype(np.int32))
        # absent keys read 0
        absent = _packed(sorted(set(_kmers(80, k, seed=k + 1000)) - set(kmers)))
        ak = _port_keys(absent)
        assert not table.lookup(tk, cn, ak, hash_words(ak)).any()


def test_duplicates_within_batch_accumulate_with_amounts():
    k = 5
    kmers = ["AACGT", "AACGT", "AACGT", "ACCCC", "AACGT", "ACCCC", "AAAAA"]
    packed = _packed(kmers)
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    amount = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    ref, ports = _both_inserts(6, packed, valid, amount)
    for tk, cn, pending in ports:
        got = _multiset(tk.numpy(), cn.numpy())
        assert got == _multiset(ref[0], ref[1])
        names = codec.unpack_kmers(np.array([r for r, _ in got], np.uint32), k)
        assert dict(zip(names, [c for _, c in got])) == {"AACGT": 11, "ACCCC": 10}
        assert not pending.any()
    # default amount: 1 per valid window
    _, ports = _both_inserts(6, packed, valid)
    tk, cn, _ = ports[0]
    assert sorted(c for _, c in _multiset(tk.numpy(), cn.numpy())) == [2, 4]


def test_insert_accumulates_across_batches_from_a_reference_table():
    """A JAX table carried over (``table_to_torch``) keeps accumulating
    as the JAX table does; back to numpy it is the JAX layout."""
    k = 31
    first = _packed(_kmers(200, k, seed=1))
    start = ref_table.make_table(9, 2)
    rk = _ref_keys(first)
    start = ref_table.insert(*start, rk, jnp.ones(200, bool), ref_hash(rk))[:2]
    second = np.concatenate([first[:50], _packed(_kmers(100, k, seed=2))])
    ref, ports = _both_inserts(9, second, np.ones(150, bool), start=start)
    for tk, cn, pending in ports:
        assert _multiset(tk.numpy(), cn.numpy()) == _multiset(ref[0], ref[1])
        back = convert.table_to_numpy(tk, cn)
        assert back[0].dtype == np.uint32 and back[1].dtype == np.int32
        assert _multiset(*back) == _multiset(ref[0], ref[1])


def test_table_conversion_round_trips():
    rng = np.random.default_rng(5)
    tk = rng.integers(0, 1 << 32, (256, 3), dtype=np.uint64).astype(np.uint32)
    tk[:5] = 0xFFFFFFFF
    cn = rng.integers(0, 1 << 31, 256).astype(np.int32)
    ptk, pcn = convert.table_to_torch(jnp.asarray(tk), jnp.asarray(cn), "cpu")
    assert ptk.dtype == torch.int32 and pcn.dtype == torch.int32
    back = convert.table_to_numpy(ptk, pcn)
    np.testing.assert_array_equal(back[0], tk)
    np.testing.assert_array_equal(back[1], cn)
    assert (ptk[:5] == -1).all()


def _invariants(tk, cn, packed, valid, amount, pending, max_probes):
    """Per key: stored count + pending amounts == input; no key in two
    slots; lookup finds every stored key with its count; occupancy ==
    distinct stored keys."""
    want = {}
    for row, v, a in zip(map(tuple, packed.tolist()), valid, amount):
        if v:
            want[row] = want.get(row, 0) + int(a)
    rows = _multiset(tk.numpy(), cn.numpy())
    stored = dict(rows)
    assert len(stored) == len(rows) == int((cn > 0).sum())
    got = dict(stored)
    for row, p, a in zip(map(tuple, packed.tolist()), pending.numpy(), amount):
        if p:
            got[row] = got.get(row, 0) + int(a)
    assert got == want
    skeys = _port_keys(np.array([r for r, _ in rows], np.uint32))
    found = table.lookup(tk, cn, skeys, hash_words(skeys), max_probes=max_probes)
    assert found.tolist() == [c for _, c in rows]
    return len(stored)


@pytest.mark.parametrize("k", [13, 51, 201])
def test_overfull_table_keeps_its_invariants(k):
    """2^8 slots and max_probes=8 for far more keys: the pending windows
    are reported exactly, and what was stored is consistent."""
    kmers = _kmers(700, k, seed=k)
    kmers += kmers[:300]                       # duplicates within the batch
    packed = _packed(kmers)
    rng = np.random.default_rng(k)
    valid = rng.random(len(kmers)) < 0.9
    amount = rng.integers(1, 6, len(kmers)).astype(np.int32)
    ref, ports = _both_inserts(8, packed, valid, amount, max_probes=8)
    rp = np.asarray(ref[2])
    for tk, cn, pending in ports:
        assert pending.any() and not (pending.numpy() & ~valid).any()
        assert _invariants(tk, cn, packed, valid, amount, pending, 8) == 256
        # the plain rounds on CPU elect the writer the JAX scatter keeps
        np.testing.assert_array_equal(pending.numpy(), rp)
        assert _multiset(tk.numpy(), cn.numpy()) == _multiset(ref[0], ref[1])
    tk, cn = table.make_table(8, packed.shape[1], "cpu")
    pk = _port_keys(packed)
    pending, npend = cuda_table.table_insert(tk, cn, pk, torch.from_numpy(valid), hash_words(pk),
                                             torch.from_numpy(amount), max_probes=8)
    assert npend.dtype == torch.int32 and npend.dim() == 0 and int(npend) == int(pending.sum())


def test_one_writer_per_claimed_slot():
    """Many distinct keys on ONE slot hash: each round exactly one of
    them claims the slot (its row whole, never torn), the others move
    on; inserting the same keys again finds each where it landed, so no
    key ends up in two slots."""
    k = 51
    packed = _packed(sorted(set(_kmers(40, k, seed=9))))
    n = packed.shape[0]
    pk = _port_keys(packed)
    h = torch.full((n,), 77, dtype=torch.int64)
    valid = torch.ones(n, dtype=torch.bool)
    tk, cn = table.make_table(7, packed.shape[1], "cpu")
    for rnd in (1, 2):
        pending, npend = cuda_table.table_insert_plain(tk, cn, pk, valid, h)
        assert int(npend) == 0
        rows = _multiset(tk.numpy(), cn.numpy())
        assert len(rows) == n and {c for _, c in rows} == {rnd}
        assert {r for r, _ in rows} == set(map(tuple, packed.tolist()))
        assert table.lookup(tk, cn, pk, h).tolist() == [rnd] * n


def test_empty_slots_with_stale_rows_count_as_empty():
    """An empty slot (count 0) whose key row holds stale words is free:
    the insert claims it and overwrites the row."""
    k = 31
    packed = _packed(sorted(set(_kmers(100, k, seed=4))))
    tk, cn = table.make_table(8, 2, "cpu")
    tk[:] = torch.from_numpy(np.random.default_rng(0).integers(-(1 << 31), 1 << 31, (256, 2),
                                                               dtype=np.int64)).to(torch.int32)
    pk = _port_keys(packed)
    valid = torch.ones(len(packed), dtype=torch.bool)
    pending, _ = cuda_table.table_insert(tk, cn, pk, valid, hash_words(pk))
    assert not pending.any()
    assert _invariants(tk, cn, packed, np.ones(len(packed), bool), np.ones(len(packed)),
                       pending, 64) == len(packed)


@pytest.mark.parametrize("n_run", [False, True])
@pytest.mark.parametrize("k", [13, 31])
def test_count_step_matches_reference(k, n_run):
    """One step from a batch's transfer chunk (K3's plain version on the
    words and bitmap; ``n_run``: with a run of 40 Ns) == the JAX step on
    the same batch's tile view, slot for slot."""
    rng = np.random.default_rng(k)
    tile, bt = 128, 4
    flat = rng.integers(0, 4, bt * tile + k - 1).astype(np.uint8)
    flat[140:142] = 4
    if n_run:
        flat[300:340] = 4
    (tiles,) = list(ref_tiling.TileBatcher(k, tile, bt).add(flat))
    W = codec.words_per_kmer(k)
    rtk, rcn, rov, rpend = ref_table.count_step(*ref_table.make_table(11, W), jnp.asarray(tiles), k)
    words, bits, n = sort_counter.pack_chunk(flat, bt * tile)
    assert n == bt * tile
    chunk = [sort_counter.to_device(a, torch.device("cpu")) for a in (words, bits)]
    for kernels in ("cuda", "plain"):
        tk, cn, ov, pend = table.count_step(*table.make_table(11, W, "cpu"), *chunk, k=k, n=n,
                                            kernels=kernels)
        assert int(ov) == int(rov) == 0 and not pend.any()
        np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.asarray(rtk))
        np.testing.assert_array_equal(cn.numpy(), np.asarray(rcn))
        keys, valid, _ = windows.windows_with_hash(torch.from_numpy(tiles), k)
        assert int(cn.sum()) == int(valid.sum())


def test_insert_checks_its_inputs():
    tk, cn = table.make_table(8, 2, "cpu")
    pk = (torch.zeros(4, dtype=torch.int64),) * 2
    v, h = torch.ones(4, dtype=torch.bool), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="kernels"):
        table.insert(tk, cn, pk, v, h, kernels="pallas")
    with pytest.raises(ValueError, match="key columns"):
        table.insert(tk, cn, pk[:1], v, h)
    with pytest.raises(ValueError, match="power of two"):
        cuda_table.table_insert(torch.zeros((6, 2), dtype=torch.int32),
                                torch.zeros(6, dtype=torch.int32), pk, v, h)
    with pytest.raises(ValueError, match="bool"):
        cuda_table.table_insert(tk, cn, pk, v.to(torch.int32), h)


def _chunk_keys(k, n, seed, bloom_share=0.0):
    """The table route's key columns of one n-window batch (K3's plain
    version on its transfer chunk) over random codes with N patches and a
    repeated stretch; with ``bloom_share`` > 0, the ``-b`` gate on a BF2
    that holds about that share of the batch's keys, so the other keys
    come back all-ones.  Returns (key columns, (n, W) uint32 rows)."""
    from kaarme_tpu_torch.models import bloom_counter
    from kaarme_tpu_torch.ops import bloom as bloom_ops, sortcount
    from kaarme_tpu_torch.ops.hashing import hash_words64

    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 4, n + k - 1).astype(np.uint8)
    flat[rng.random(flat.shape[0]) < 0.004] = 4
    flat[n // 2: n // 2 + 2 * k] = flat[: 2 * k]            # keys seen twice in the batch
    words, bits, m = sort_counter.pack_chunk(flat, n)
    chunk = dict(packed=sort_counter.to_device(words, torch.device("cpu")),
                 sep=sort_counter.to_device(bits, torch.device("cpu")), k=k, n=m)
    gate = {}
    if bloom_share:
        keys = sortcount.window_keys_from_chunk(**chunk)
        _, hfn, _, bf2 = bloom_counter.make_filters(n, 0.001, "cpu")
        r1, r2 = hash_words64(keys)
        held = (sortcount._is_sentinel_i32(keys) == 0) & torch.from_numpy(
            rng.random(m) < bloom_share)
        gate = dict(bloom=bloom_ops.set_bits(bf2, r1, r2, hfn, held), hfn=hfn)
    keys = sortcount.window_keys_from_chunk(**chunk, **gate)
    return keys, torch.stack(keys, 1).numpy().view(np.uint32)


def _ref_derived(cap_log2, rows, amount=None, max_probes=64):
    """The JAX insert fed what T1 derives: valid = not all-ones in every
    word, h = ``hash_words`` of the key words."""
    rk = _ref_keys(rows)
    valid = ~(rows == 0xFFFFFFFF).all(1)
    tk, cn = ref_table.make_table(cap_log2, rows.shape[1])
    ramt = None if amount is None else jnp.asarray(amount)
    out = ref_table.insert(tk, cn, rk, jnp.asarray(valid), ref_hash(rk), ramt,
                           max_probes=max_probes)
    return out, valid


@pytest.mark.parametrize("kernels", ["cuda", "plain"])
@pytest.mark.parametrize("cap_log2,max_probes", [(12, 64), (8, 8)], ids=["roomy", "overfull"])
@pytest.mark.parametrize("k", [13, 51, 201])
def test_insert_derives_validity_and_hash_as_reference(k, cap_log2, max_probes, kernels):
    """``insert(..., valid=None, h=None)`` on the route's key columns ==
    the JAX insert fed valid = not all-ones and h = hash_words(keys): the
    same occupied (key row, count) multiset and the same pending set,
    also when the table overflows."""
    keys, rows = _chunk_keys(k, 1024, seed=k)
    (rtk, rcn, rpend), valid = _ref_derived(cap_log2, rows, max_probes=max_probes)
    assert 0 < int((~valid).sum()) < valid.shape[0]
    tk, cn = table.make_table(cap_log2, rows.shape[1], "cpu")
    tk, cn, pending, n_pending = table.insert(tk, cn, keys, max_probes=max_probes,
                                              kernels=kernels)
    assert _multiset(tk.numpy(), cn.numpy()) == _multiset(rtk, rcn)
    np.testing.assert_array_equal(pending.numpy(), np.asarray(rpend))
    assert int(n_pending) == int(pending.sum())
    assert bool(pending.any()) == (cap_log2 == 8)
    if cap_log2 == 12:
        assert int(cn.sum()) == int(valid.sum())


@pytest.mark.parametrize("k", [13, 51, 201])
def test_insert_derives_validity_after_bloom_gate_with_amounts(k):
    """A batch whose Bloom-missed keys the ``-b`` gate turned all-ones,
    with amounts 1-5: derived validity and hash == the JAX insert fed
    them, exactly; the gated windows add nothing."""
    keys, rows = _chunk_keys(k, 1024, seed=k + 7, bloom_share=0.5)
    amount = np.random.default_rng(k).integers(1, 6, rows.shape[0]).astype(np.int32)
    (rtk, rcn, rpend), valid = _ref_derived(12, rows, amount)
    assert 300 < int((~valid).sum()) < 800                     # gated and invalid windows
    for kernels in ("cuda", "plain"):
        tk, cn = table.make_table(12, rows.shape[1], "cpu")
        tk, cn, pending, _ = table.insert(tk, cn, keys, amount=torch.from_numpy(amount),
                                          kernels=kernels)
        assert not pending.any() and not np.asarray(rpend).any()
        assert _multiset(tk.numpy(), cn.numpy()) == _multiset(rtk, rcn)
        assert int(cn.sum()) == int(amount[valid].sum())


def test_key_columns_pass_views_and_stack_the_rest():
    """T1 reads K3's (W, N) columns and a table's ``tk[:, w]`` where they
    lie (word w of window i at w * lw + i * li) and a copy of anything
    else."""
    k3 = torch.arange(3 * 10, dtype=torch.int32).view(3, 10)
    buf, lw, li = cuda_table._key_columns(tuple(k3.unbind(0)))
    assert buf.data_ptr() == k3.data_ptr() and (lw, li) == (10, 1)
    tk = torch.arange(10 * 4, dtype=torch.int32).view(10, 4)
    buf, lw, li = cuda_table._key_columns(tuple(tk[:, w] for w in range(4)))
    assert buf.data_ptr() == tk.data_ptr() and (lw, li) == (1, 4)
    buf, lw, li = cuda_table._key_columns((k3[0], k3[2]))
    assert buf.data_ptr() == k3.data_ptr() and (lw, li) == (20, 1)
    for cols in ((k3[1].to(torch.int64), k3[2].to(torch.int64)), (k3[0], k3[1].clone()),
                 (k3[0], k3[1][::2].repeat(2))):
        buf, lw, li = cuda_table._key_columns(cols)
        assert buf.shape == (2, 10) and (lw, li) == (10, 1)
        assert torch.equal(buf, torch.stack([c.to(torch.int32) for c in cols]))
    flat = k3.view(-1)
    buf, lw, li = cuda_table._key_columns((flat[3:8], flat[13:18]))
    assert buf.data_ptr() == flat[3:].data_ptr() and (lw, li) == (10, 1)


@pytest.mark.parametrize("k", [13, 51, 201])
def test_grow_path_matches_reference(k):
    """The counter's grow and retry (migration with the stored counts as
    amounts, then the pending windows as ``valid``, no host hashes) ==
    the JAX counter: the same grow events and table."""
    from kaarme_tpu.models.counter import CounterConfig as RefConfig, KmerCounter as RefCounter
    from kaarme_tpu_torch.models.counter import CounterConfig, KmerCounter

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 1200).astype(np.uint8)
    codes[rng.random(1200) < 0.002] = 4
    kw = dict(k=k, min_slots=256, tile=128, batch_tiles=2, min_abundance=1)
    port = KmerCounter(CounterConfig(device="cpu", **kw)).count_codes(codes)
    ref = RefCounter(RefConfig(**kw)).count_codes(codes)
    assert port.stats["grow_events"] == ref.stats["grow_events"] >= 1
    assert port.occupancy() == ref.occupancy()
    assert port.as_dict() == ref.as_dict() == codec.golden_count(codes, k)
    ptk, pcn = port.dump()
    rtk, rcn = ref.dump()
    assert _multiset(ptk, pcn) == _multiset(np.asarray(rtk), np.asarray(rcn))


@pytest.mark.parametrize("k", [13, 51])
def test_sharded_path_matches_reference(k):
    """The sharded table (records routed by the hash they carry, inserted
    with valid=None on the owner) == the JAX sharded table on two
    shards: every shard's slots, grow events."""
    from kaarme_tpu.parallel.sharded import (ShardedCounterConfig as RefConfig,
                                             ShardedKmerCounter as RefCounter,
                                             make_mesh as ref_mesh)
    from kaarme_tpu_torch.parallel import ShardedCounterConfig, ShardedKmerCounter, make_mesh

    rng = np.random.default_rng(k + 1)
    codes = rng.integers(0, 4, 1500).astype(np.uint8)
    codes[rng.random(1500) < 0.01] = 4
    kw = dict(k=k, min_slots=1 << 9, tile=128, batch_tiles=4, min_abundance=1, max_probes=8)
    port = ShardedKmerCounter(ShardedCounterConfig(**kw), make_mesh(2, "cpu")).count_codes(codes)
    ref = RefCounter(RefConfig(**kw), ref_mesh(2)).count_codes(codes)
    ptk, pcn = port._host_table()
    np.testing.assert_array_equal(ptk, np.asarray(ref.tkeys))
    np.testing.assert_array_equal(pcn, np.asarray(ref.counts))
    assert port.stats["grow_events"] == ref.stats["grow_events"] >= 1
    assert port.as_dict() == codec.golden_count(codes, k)
