"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device: every test skips without one (the kernels have no
CPU mode).  This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerance 0: every compared quantity is an integer.
"""

import numpy as np
import pytest
import torch

from chunk_noise import noisy_tail
from kaarme_tpu_torch import cli
from kaarme_tpu_torch.io import fastio
from kaarme_tpu_torch.ops import cuda_compact, cuda_merge, cuda_skm, cuda_winkeys, sortcount


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _codes(n, k, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n + k - 1).astype(np.int32)
    c[::151] = 4
    c[1000:1003] = 5                 # base bits under an invalid flag
    return c


def _chunk(n, k, seed, no_sep=False):
    """The transfer chunk K1, K3 and K5 read: packed 2-bit words (random
    bases under the invalid positions too) and the bitmap, with one more
    word of each and random bases and bits at and past L (``noisy_tail``),
    which the kernels must ignore as the plain versions do.  A poly-A
    stretch without separators keeps one minimizer over several tiles, so
    the LMAX cap is anchored at a TRUE start tiles back."""
    rng = np.random.default_rng(seed)
    L = n + k - 1
    bases = rng.integers(0, 4, L).astype(np.uint8)
    inv = np.zeros(L, bool)
    if not no_sep:
        inv[::151] = True
        inv[1000:1003] = True
        inv[5000:9000] = False
    bases[5000:9000] = 0
    packed, _ = fastio.pack_stream_np(bases)
    _, mask = fastio.pack_stream_np(inv.astype(np.uint8) * 4)
    return noisy_tail(packed, mask, L, seed)


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(16, 5000), (31, 1 << 15), (51, 1 << 20), (51, 777),
                                 (101, 100_003), (201, 30_001)])
def test_k1_kernel_equals_plain(dev, k, n):
    """From the chunk; n = 777 is a tail shorter than a tile."""
    packed, mask = _chunk(n, k, seed=k)
    p, s = _dev(packed, dev), _dev(mask, dev)
    for cap in (n // 4, 1024, 0):
        got = cuda_skm.run_rows_dense(p, s, k=k, n=n, cap=cap)
        want = cuda_skm.run_rows_dense_plain(p, s, k=k, n=n, cap=cap)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k1_chunk_without_separators(dev):
    k, n = 51, 70_001
    packed, mask = _chunk(n, k, seed=2, no_sep=True)
    p, s = _dev(packed, dev), _dev(mask, dev)
    got = cuda_skm.run_rows_dense(p, s, k=k, n=n, cap=n)
    want = cuda_skm.run_rows_dense_plain(p, s, k=k, n=n, cap=n)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and int(want[1][0]) > 0
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k1_writes_nothing_past_cap(dev):
    k, n = 51, 1 << 18
    packed, mask = _chunk(n, k, seed=5)
    p, s = _dev(packed, dev), _dev(mask, dev)
    _, rows = cuda_skm.run_rows_dense_plain(p, s, k=k, n=n, cap=0)
    cap = int(rows[0]) // 2
    out = torch.full((cuda_skm.content_words(k) + 1, cap + 333), 77, dtype=torch.int32,
                     device=dev)
    cols, r = cuda_skm.launch_dense(p, s, k, n, out, cap)
    torch.cuda.synchronize()
    assert r.tolist() == rows.tolist()
    assert bool((out[:, cap:] == 77).all())
    want, _ = cuda_skm.run_rows_dense_plain(p, s, k=k, n=n, cap=cap)
    for a, b in zip(cols, want):
        assert torch.equal(a, b)


def _k5_equal(dev, packed, s, k, n, S):
    p, s = _dev(packed, dev), _dev(s, dev)
    got = cuda_skm.run_rows_slotted(p, s, k=k, n=n, S=S)
    want = cuda_skm.run_rows_slotted_plain(p, s, k=k, n=n, S=S)
    torch.cuda.synchronize()
    assert int(got[1]) == int(want[1])
    assert len(got[0]) == len(want[0]) == cuda_skm.content_words(k) + 1
    for a, b in zip(got[0], want[0]):
        assert a.shape[0] == cuda_skm.slot_rows(n, S)
        assert torch.equal(a, b)
    return int(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,S", [(16, 5000, 96), (31, 1 << 15, 16), (51, 1 << 20, 96),
                                   (51, 777, 8), (101, 100_003, 512), (17, 1 << 16, 4)])
def test_k5_kernel_equals_plain(dev, k, n, S):
    """From the chunk: slotted rows and max_tile_runs bit for bit; n = 777
    and 100,003 end in a partial slot tile, and S = 4 (and 8, 16)
    overflow: the same rows are dropped.  The chunk's poly-A stretch keeps
    one minimizer across tiles."""
    packed, mask = _chunk(n, k, seed=k + S, no_sep=S == 4)   # S = 4: minimizer churn
    most = _k5_equal(dev, packed, mask, k, n, S)
    if S <= 16:
        assert most > S


@pytest.mark.cuda
def test_k5_chunk_without_separators(dev):
    k, n = 51, 70_001
    packed, mask = _chunk(n, k, seed=2, no_sep=True)
    assert _k5_equal(dev, packed, mask, k, n, 96) > 0


@pytest.mark.cuda
def test_slotted_counter_kernels_equal_plain_through_the_ladder(dev):
    """SkmCounter(segpack="slotted", skm_slots=8) on the card: K5 runs on
    every superstep (replays included), the S-ladder climbs, and the
    dump equals the plain route's."""
    from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig

    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    starts = rng.integers(0, 20_000 - 150, 3000)
    reads = np.full((3000, 151), 4, np.uint8)
    reads[:, :150] = genome[starts[:, None] + np.arange(150)]
    codes = reads.reshape(-1)
    kw = dict(k=31, min_abundance=1, batch_windows=1 << 15, superbatch_batches=2,
              prefix_cap=1 << 16, segpack="slotted", skm_slots=8)
    cuda_skm.run_rows_slotted.launches = 0
    c = SkmCounter(SkmCounterConfig(device="cuda", **kw)).count_codes(codes)
    assert c.stats["slot_grow_events"] > 0
    assert (cuda_skm.run_rows_slotted.launches
            == c.stats["batches"] + c.stats["replayed_supersteps"] > c.stats["batches"])
    p = SkmCounter(SkmCounterConfig(device="cuda", kernels="plain", **kw)).count_codes(codes)
    for a, b in zip(c.dump(), p.dump()):
        assert np.array_equal(a, b)
    assert int(c.dump()[1].sum()) == 3000 * (150 - 31 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k,extra", [(13, []), (31, ["--pipeline", "classic"]),
                                     (31, ["--pipeline", "classic", "--compactor", "merge"]),
                                     (51, [])])
def test_bloom_cli_kernels_equal_plain_route(dev, tmp_path, k, extra):
    """-b -u on the card: pass 1 runs K3, pass 2 the route's kernels; the
    count file equals --kernels plain and the -a 1 file without its
    count-1 lines."""
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 30_000)
    starts = rng.integers(0, 30_000 - 150, 2000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r.fa", "wb") as f:
        for i, s0 in enumerate(starts):
            f.write(b">r%d\n%s\n" % (i, lut[genome[s0:s0 + 150]].tobytes()))
    from kaarme_tpu_torch.ops import cuda_bloom

    argv = [str(tmp_path / "r.fa"), str(k), "-q"] + extra
    a, b, c = tmp_path / "b.txt", tmp_path / "p.txt", tmp_path / "a1.txt"
    kernels = (cuda_winkeys.window_keys, cuda_bloom.bloom_insert, cuda_bloom.bloom_gate)
    for fn in kernels:
        fn.launches = 0
    assert cli.main(argv + ["-b", "-u", "40000", "-a", "2", "-o", str(a)]) == 0
    assert all(fn.launches > 0 for fn in kernels)
    for fn in kernels:
        fn.launches = 0
    assert cli.main(argv + ["-b", "-u", "40000", "-a", "2", "-o", str(b),
                            "--kernels", "plain"]) == 0
    assert all(fn.launches == 0 for fn in kernels)
    assert a.read_bytes() == b.read_bytes()
    assert cli.main(argv + ["-s", "100000", "-a", "1", "-o", str(c)]) == 0
    want = b"".join(ln + b"\n" for ln in c.read_bytes().splitlines()
                    if not ln.endswith(b" 1"))
    assert a.read_bytes() == want


def _sorted_rows(dev, W, N, embedded, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, (W, N)).astype(np.int64)
    keys[0] |= 0x80000000
    keys[:, ::9] = 0xFFFFFFFF                       # sentinel rows
    if embedded:
        keys[-1] = ((keys[-1] << 26) & 0xFFFFFFFF) | rng.integers(1, 1 << 21, N)
        keys[:, ::9] = 0xFFFFFFFF
    cols = [torch.from_numpy(keys[w].astype(np.uint32).view(np.int32)).to(dev)
            for w in range(W)]
    if not embedded:
        cols.append(torch.from_numpy(rng.integers(0, 1 << 21, N).astype(np.int32)).to(dev))
    s = sortcount.lexsort(cols, num_keys=W)
    return (s, None) if embedded else (s[:W].contiguous(), s[W].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,embedded", [(6, 300_000, True), (6, 2047, True),
                                          (4, 500_000, False), (1, 5000, False),
                                          (3, 0, True), (3, 0, False)])
def test_k2_kernel_equals_plain(dev, W, N, embedded):
    keys, cnt = _sorted_rows(dev, W, N, embedded, seed=W * 7 + N)
    eb = 26 if embedded else 0
    for out_len in (N, N // 3):
        got = cuda_compact.segsum_compact(keys, cnt, ebits=eb, out_len=out_len)
        want = cuda_compact.segsum_compact_torch(keys, cnt, ebits=eb, out_len=out_len)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2, 100), (13, 1 << 16), (16, 4097), (17, 2049), (31, 1023),
                                 (51, 1 << 20), (51, 100_003), (201, 3001), (49_200, 37)])
def test_k3_kernel_equals_plain(dev, k, n):
    """From the chunk; n = 4097, 2049, 100,003 end in a partial tile of
    2048 windows.  k=49,200 stages ~25 KB of chunk per tile; its plain
    version runs on the CPU (tens of thousands of tiny ops)."""
    packed, mask = _chunk(n, k, seed=k + n)
    p, s = _dev(packed, dev), _dev(mask, dev)
    got = cuda_winkeys.window_keys(p, s, k=k, n=n)
    where = (lambda t: t.cpu()) if k > 1000 else (lambda t: t)
    want = cuda_winkeys.window_keys_plain(where(p), where(s), k=k, n=n)
    torch.cuda.synchronize()
    assert len(got) == len(want) == -(-k // 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["embedded", "plain", "merged_k51", "merged_k13", "bloom_pass1"])
def test_classic_superstep_does_not_unpack(dev, monkeypatch, route):
    """The classic supersteps and -b pass 1 on the kernel route never
    reach the unpack: ``codes_from_chunk`` (and the unpack helper)
    raise, and the result equals the plain route's, which unpacks."""
    from kaarme_tpu_torch.ops import bloom

    k = 13 if route in ("plain", "merged_k13") else 51
    n = 100_000
    packed, mask = _chunk(n, k, seed=len(route))
    p, s = _dev(packed, dev), _dev(mask, dev)
    W = -(-k // 16)
    eb = sortcount.embed_bits(k)

    def step(kernels):
        prefix = sortcount.make_store(1 << 17, W, dev)
        kw = dict(k=k, n=n, kernels=kernels)
        if route == "embedded":
            return sortcount.superstep_embedded(p, s, prefix, ebits=eb, **kw)
        if route == "plain":
            return sortcount.superstep_plain(p, s, prefix, **kw)
        if route.startswith("merged"):
            return sortcount.superstep_merged(p, s, prefix, ebits=eb, **kw)
        bf1, bf2 = bloom.make_bloom(1 << 20, dev), bloom.make_bloom(1 << 20, dev)
        return sortcount.bloom_pass1_superstep(bf1, bf2, p, s, hfn=4, **kw)

    want = step("plain")

    def boom(*a, **kw):
        raise AssertionError("the kernel route unpacked the chunk")

    for name in ("codes_from_chunk", "unpack_codes"):
        monkeypatch.setattr(sortcount, name, boom)
    cuda_winkeys.window_keys.launches = 0
    got = step("cuda")
    torch.cuda.synchronize()
    assert cuda_winkeys.window_keys.launches == 1
    flat = lambda r: [t for part in r for t in (part if isinstance(part, tuple) else (part,))]
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())


def _k2_equal(keys, cnt, eb, out_len, guard=0):
    """The kernel against the plain version; with ``guard``, launched
    into a buffer with that many columns past out_len, which must stay
    untouched."""
    W = keys.shape[0]
    want = cuda_compact.segsum_compact_torch(keys, cnt, ebits=eb, out_len=out_len)
    if guard:
        out = torch.full((W + 1, out_len + guard), 0x5A5A5A5A, dtype=torch.int32,
                         device=keys.device)
        got = cuda_compact.launch_compact(keys, cnt, out, out_len, ebits=eb)
    else:
        got = cuda_compact.segsum_compact(keys, cnt, ebits=eb, out_len=out_len)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if guard:
        assert bool((out[:, out_len:] == 0x5A5A5A5A).all())
    return [int(x) for x in want[2]]


@pytest.mark.cuda
@pytest.mark.parametrize("embedded", [True, False], ids=["embedded", "full_sum"])
@pytest.mark.parametrize("N", [0, 1, 2047, 2048, 2049])
@pytest.mark.parametrize("W", [1, 5, 6, 15])
def test_k2_tile_edges_equal_plain(dev, W, N, embedded):
    """N at the edges of the kernel's 2048-row tile, at the widths the
    paths pass (k=13: 1, finalize: 5, k=51 merge: 6, k=201 merge: 15);
    out_len above N (the tail fill) and below nd (a guard past it)."""
    keys, cnt = _sorted_rows(dev, W, N, embedded, seed=W * 11 + N)
    eb = 26 if embedded else 0
    nd = _k2_equal(keys, cnt, eb, N)[0]
    _k2_equal(keys, cnt, eb, N + 100, guard=64)
    _k2_equal(keys, cnt, eb, nd // 2, guard=64)


@pytest.mark.cuda
@pytest.mark.parametrize("embedded", [True, False], ids=["embedded", "full_sum"])
def test_k2_segment_across_tiles_equals_plain(dev, embedded):
    """One key over more than 64 tiles (its first rows' carry comes only
    from the look-back, over more than one round of 32 tiles), whose
    total crosses the 2^20 clamp: embedded, c_last near 2^20 plus the
    length; full_sum, ~2^17 counts near 2^20 (the clamped sum crosses
    2^20 again and again).  Then an input of sentinels only."""
    N = 66 * 2048 + 77
    W = 2 if embedded else 1
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 1 << 32, (W, N), dtype=np.uint64).astype(np.int64)
    keys[:, 100:N - 300] = keys[:, 100:101]
    keys[:, N - 50:] = 0xFFFFFFFF
    if embedded:
        keys[-1] = (keys[-1] & ~((1 << 26) - 1) & 0xFFFFFFFF) | 1
        keys[-1, 100] |= (1 << 20) - 10
        keys[:, N - 50:] = 0xFFFFFFFF
    cols = [torch.from_numpy(keys[w].astype(np.uint32).view(np.int32)).to(dev) for w in range(W)]
    if not embedded:
        c = rng.integers((1 << 20) - 3, 1 << 20, N)
        c[N - 50:] = 0
        cols.append(torch.from_numpy(c.astype(np.int32)).to(dev))
    s = sortcount.lexsort(cols, num_keys=W)
    k, c = (s, None) if embedded else (s[:W].contiguous(), s[W].contiguous())
    eb = 26 if embedded else 0
    nd = _k2_equal(k, c, eb, N, guard=16)[0]
    assert nd > 2
    _k2_equal(k, c, eb, nd - 1, guard=16)
    sent = torch.full((3, 5000), -1, dtype=torch.int32, device=dev)
    assert _k2_equal(sent, None, 26, 5000, guard=8) == [0, 0]


def _runs(dev, W, na, nb, embedded, seed, pad_a=0, pad_b=0, span=40):
    """A: na distinct sorted keys with counts (+ pad_a sentinel rows);
    B: nb sorted keys with repeats (+ pad_b sentinel rows)."""
    rng = np.random.default_rng(seed)
    eb = 26 if embedded else 0
    low = ((1 << 32) - 1) ^ ((1 << eb) - 1)          # key bits of the last word

    def keys(m):
        x = rng.integers(0, span, (m, W)).astype(np.int64)
        x[:, 0] |= 0x80000000
        x[:, -1] = (x[:, -1] << eb) & low
        return x

    a = np.unique(keys(na), axis=0)[:na]
    b = keys(nb)
    b = b[np.lexsort(b.T[::-1])]
    acnt = rng.integers(1, 1 << 21, a.shape[0])
    if embedded:
        a[:, -1] |= acnt
        b[:, -1] |= 1
    a = np.concatenate([a, np.full((pad_a, W), 0xFFFFFFFF)])
    b = np.concatenate([b, np.full((pad_b, W), 0xFFFFFFFF)])
    ta = [a[:, w] for w in range(W)]
    if not embedded:
        ta.append(np.concatenate([acnt, np.zeros(pad_a, np.int64)]))
    to = lambda cols: torch.from_numpy(
        np.stack(cols).astype(np.uint32).view(np.int32)).to(dev)
    return to(ta), to([b[:, w] for w in range(W)]), eb


@pytest.mark.cuda
@pytest.mark.parametrize("W,na,nb,embedded", [
    (4, 3000, 70_000, True), (1, 500, 9000, False), (2, 6000, 6000, False),
    (13, 900, 5000, True), (20, 700, 3000, False), (3, 0, 4000, True),
    (3, 2000, 0, False), (2, 0, 0, True), (1, 0, 30_000, False), (4, 0, 9000, True),
    (13, 0, 4000, False), (1, 20_000, 0, True), (4, 3000, 0, False), (13, 1500, 0, True),
    (1, 0, 0, False), (13, 0, 0, True), (70, 300, 2000, True)])
def test_k4_kernel_equals_plain(dev, W, na, nb, embedded):
    a, b, eb = _runs(dev, W, na, nb, embedded, seed=W + na + nb, pad_a=300, pad_b=77)
    n = a.shape[1] + b.shape[1]
    for out_len in (n, n // 3):
        got = cuda_merge.merge_compact(a, b, embedded=embedded, ebits=eb, out_len=out_len)
        want = cuda_merge.merge_compact_torch(a, b, embedded=embedded, ebits=eb,
                                              out_len=out_len)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("embedded", [True, False])
def test_k4_exact_fit_and_overflow_guard(dev, embedded):
    """Both runs full of real rows, no sentinel anywhere; then an output
    capacity below nd must leave a guard region past it untouched."""
    a, b, eb = _runs(dev, 2, 4096, 4096, embedded, seed=8, span=1 << 12)
    want = cuda_merge.merge_compact_torch(a, b, embedded=embedded, ebits=eb)
    got = cuda_merge.merge_compact(a, b, embedded=embedded, ebits=eb)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    nd = int(want[2][0])
    small = nd // 2
    out = torch.full((3, small + 999), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    keys, cnt, ndv = cuda_merge.launch_merge(a, b, out, small, embedded=embedded, ebits=eb)
    torch.cuda.synchronize()
    assert ndv.tolist() == [nd, nd]
    assert bool((out[:, small:] == 0x5A5A5A5A).all())
    assert torch.equal(keys, want[0][:, :small]) and torch.equal(cnt, want[1][:small])


def _hot_runs(dev, W, embedded, n_hot, seed):
    """A key with one A row (count 2^20 - 7) and n_hot B rows, among 300
    other A keys and 900 other B rows, sentinels after both runs."""
    rng = np.random.default_rng(seed)
    eb = 26 if embedded else 0
    low = ((1 << 32) - 1) ^ ((1 << eb) - 1)

    def keys(m):
        x = rng.integers(0, 1 << 20, (m, W)).astype(np.int64)
        x[:, 0] |= 0x80000000
        x[:, -1] = (x[:, -1] << eb) & low
        return x

    key = keys(1)
    a = np.unique(np.concatenate([keys(300), key]), axis=0)
    acnt = rng.integers(1, 100, a.shape[0])
    acnt[(a == key).all(1)] = (1 << 20) - 7
    b = np.concatenate([keys(900), np.repeat(key, n_hot, 0)])
    b = b[np.lexsort(b.T[::-1])]
    if embedded:
        a[:, -1] |= acnt
        b[:, -1] |= 1
    a = np.concatenate([a, np.full((33, W), 0xFFFFFFFF)])
    b = np.concatenate([b, np.full((21, W), 0xFFFFFFFF)])
    ta = [a[:, w] for w in range(W)]
    if not embedded:
        ta.append(np.concatenate([acnt, np.zeros(33, np.int64)]))
    to = lambda cols: torch.from_numpy(
        np.stack(cols).astype(np.uint32).view(np.int32)).to(dev)
    return to(ta), to([b[:, w] for w in range(W)]), eb


@pytest.mark.cuda
@pytest.mark.parametrize("embedded", [True, False], ids=["embedded", "separate"])
@pytest.mark.parametrize("W", [1, 4, 13])
def test_k4_hot_key_across_tiles_equals_plain(dev, W, embedded):
    """One key over more than 64 of the kernel's tiles at every W (its
    carry comes from the look-back only, over more than two rounds of 32
    tiles), its total crossing the 2^20 clamp; then out_len < nd into a
    buffer whose guard past out_len must stay untouched."""
    a, b, eb = _hot_runs(dev, W, embedded, 66 * 4096 + 77, seed=W)
    want = cuda_merge.merge_compact_torch(a, b, embedded=embedded, ebits=eb)
    got = cuda_merge.merge_compact(a, b, embedded=embedded, ebits=eb)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    nd = int(want[2][0])
    assert int(want[1].max()) > 1 << 20 and nd > 30
    small = nd // 2
    out = torch.full((W + 1, small + 333), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    keys, cnt, ndv = cuda_merge.launch_merge(a, b, out, small, embedded=embedded, ebits=eb)
    torch.cuda.synchronize()
    assert ndv.tolist() == [nd, nd]
    assert bool((out[:, small:] == 0x5A5A5A5A).all())
    assert torch.equal(keys, want[0][:, :small]) and torch.equal(cnt, want[1][:small])


@pytest.mark.cuda
@pytest.mark.parametrize("embedded", [True, False], ids=["embedded", "separate"])
def test_k4_allocates_no_merged_rows(dev, embedded):
    """One launch allocates its scratch and verdict only: the peak over
    the call stays far below a (W+1, na+nb) buffer of merged rows."""
    from kaarme_tpu_torch.ops import _build

    W = 4
    a, b, eb = _runs(dev, W, 200_000, 2_000_000, embedded, seed=5, pad_a=1000, pad_b=100,
                     span=1 << 20)
    na, nb = a.shape[1], b.shape[1]
    out = torch.empty((W + 1, na + nb), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_merge.launch_merge(a, b, out, na + nb, embedded=embedded, ebits=eb)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    scratch = 8 * _build.lib().kt_merge_compact_scratch(na, nb, W)
    assert extra <= scratch + 2 * 512 + 4096
    assert extra < (W + 1) * (na + nb) * 4 // 50


@pytest.mark.cuda
@pytest.mark.parametrize("k,extra", [(13, []), (31, ["--pipeline", "classic"]),
                                     (51, ["--pipeline", "classic", "--compactor", "merge"])])
def test_classic_cli_kernels_equal_plain_route(dev, tmp_path, k, extra):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 30_000)
    starts = rng.integers(0, 30_000 - 150, 2000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r.fa", "wb") as f:
        for i, s0 in enumerate(starts):
            f.write(b">r%d\n%s\n" % (i, lut[genome[s0:s0 + 150]].tobytes()))
    cuda_winkeys.window_keys.launches = 0
    a, b = tmp_path / "k.txt", tmp_path / "p.txt"
    argv = [str(tmp_path / "r.fa"), str(k), "-s", "100000", "-a", "1", "-q"] + extra
    assert cli.main(argv + ["-o", str(a)]) == 0
    assert cuda_winkeys.window_keys.launches > 0
    assert cli.main(argv + ["-o", str(b), "--kernels", "plain"]) == 0
    assert a.read_bytes() == b.read_bytes()
    counts = [int(ln.split()[1]) for ln in a.read_bytes().splitlines()]
    assert sum(counts) == 2000 * (150 - k + 1)


@pytest.mark.cuda
def test_cli_kernels_equal_plain_route(dev, tmp_path):
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 30_000)
    starts = rng.integers(0, 30_000 - 150, 2000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r.fa", "wb") as f:
        for i, s0 in enumerate(starts):
            f.write(b">r%d\n%s\n" % (i, lut[genome[s0:s0 + 150]].tobytes()))
    cuda_skm.run_rows_dense.launches = cuda_compact.segsum_compact.launches = 0
    a, b = tmp_path / "k.txt", tmp_path / "p.txt"
    assert cli.main([str(tmp_path / "r.fa"), "51", "-s", "100000", "-a", "1", "-q",
                     "-o", str(a)]) == 0
    assert cuda_skm.run_rows_dense.launches > 0 and cuda_compact.segsum_compact.launches > 0
    assert cli.main([str(tmp_path / "r.fa"), "51", "-s", "100000", "-a", "1", "-q",
                     "-o", str(b), "--kernels", "plain"]) == 0
    assert a.read_bytes() == b.read_bytes()
    counts = [int(ln.split()[1]) for ln in a.read_bytes().splitlines()]
    assert sum(counts) == 2000 * 100


def _table_multiset(tk, cn):
    """Occupied (key row, count) pairs sorted by key, (W+1, m) int32."""
    occ = cn > 0
    return sortcount.lexsort(list(tk[occ].T) + [cn[occ]], num_keys=tk.shape[1])


def _table_keys(n, k, seed, dev):
    """Canonical keys, validity and hashes of n windows of a random
    stream with N patches, cut as the table route cuts them."""
    from kaarme_tpu_torch.ops import windows

    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n + k - 1).astype(np.int32)
    c[::997] = 4
    c[500:503] = 4
    c = torch.from_numpy(c).to(dev)
    return windows.windows_with_hash(c.unfold(0, n // 4 + k - 1, n // 4), k)


def _check_table_invariants(tk, cn, max_probes=64, hash_fn=None):
    from kaarme_tpu_torch.ops import hashing, table

    rows = _table_multiset(tk, cn)
    W = tk.shape[1]
    if rows.shape[1] > 1:
        assert bool((rows[:W, 1:] != rows[:W, :-1]).any(0).all())     # no key in two slots
    keys = tuple(rows[:W])
    h = (hash_fn or hashing.hash_words)(keys)
    found = table.lookup(tk, cn, keys, h, max_probes=max_probes)
    assert torch.equal(found, rows[W])
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("k", [13, 31, 51, 201])
def test_t1_equals_plain(dev, k):
    """From a table holding a first batch, a second batch (half of it the
    first's windows again): the same multiset of (key row, count) from
    the kernel and the plain rounds, no pending, the invariants."""
    from kaarme_tpu_torch.ops import cuda_table, table

    n = 1 << 16
    first = _table_keys(n, k, seed=k, dev=dev)
    second = _table_keys(n, k, seed=k + 1, dev=dev)
    second = (tuple(torch.cat([a[: n // 2], b[n // 2:]]) for a, b in zip(first[0], second[0])),
              torch.cat([first[1][: n // 2], second[1][n // 2:]]),
              torch.cat([first[2][: n // 2], second[2][n // 2:]]))
    tk, cn = table.make_table(18, (k + 15) // 16, dev)
    assert int(cuda_table.table_insert(tk, cn, *first)[1]) == 0
    a, b = (tk.clone(), cn.clone()), (tk.clone(), cn.clone())
    pk, nk = cuda_table.table_insert(*a, *second)
    pp, np_ = cuda_table.table_insert_plain(*b, *second)
    torch.cuda.synchronize()
    assert int(nk) == int(np_) == 0 and not pk.any() and not pp.any()
    assert torch.equal(_check_table_invariants(*a), _check_table_invariants(*b))
    assert int(a[1].sum()) == int(first[1].sum()) + int(second[1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("amount", [False, True])
def test_t1_poly_a_one_slot(dev, amount):
    """Every lane on one key: the atomics serialise, the total is exact."""
    from kaarme_tpu_torch.ops import cuda_table, table, windows

    k, n = 51, 1 << 20
    keys, valid, h = windows.windows_with_hash(torch.zeros((1, n + k - 1), dtype=torch.int32,
                                                           device=dev), k)
    amt = torch.full((n,), 3, dtype=torch.int32, device=dev) if amount else None
    tk, cn = table.make_table(10, 4, dev)
    pend, npend = cuda_table.table_insert(tk, cn, keys, valid, h, amt)
    assert int(npend) == 0 and int((cn > 0).sum()) == 1
    assert int(cn.sum()) == n * (3 if amount else 1)
    assert not tk[cn > 0].any()                     # poly-A is the all-zero key


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["kernel", "plain"])
@pytest.mark.parametrize("k", [13, 51, 201])
def test_t1_overfull_invariants(dev, k, fn):
    """2^8 slots, max_probes=8, amounts 1-5: stored + pending == input
    per key; pending counted exactly; no key in two slots."""
    from kaarme_tpu_torch.ops import cuda_table, table

    keys, valid, h = _table_keys(4000, k, seed=k, dev=dev)
    g = torch.Generator(device=dev).manual_seed(k)
    amt = torch.randint(1, 6, valid.shape, generator=g, device=dev, dtype=torch.int32)
    tk, cn = table.make_table(8, len(keys), dev)
    run = cuda_table.table_insert if fn == "kernel" else cuda_table.table_insert_plain
    pend, npend = run(tk, cn, keys, valid, h, amt, max_probes=8)
    assert int(npend) == int(pend.sum()) > 0 and not (pend & ~valid).any()
    rows = _check_table_invariants(tk, cn, 8)
    W = len(keys)

    def totals(cols, a):
        uk, inv = torch.unique(torch.stack([sortcount.i32(c) for c in cols]), dim=1,
                               return_inverse=True)
        return uk, torch.zeros(uk.shape[1], dtype=torch.int64, device=dev).index_add_(
            0, inv, a.long())

    want = totals([x[valid] for x in keys], amt[valid])
    got = totals([torch.cat([r, sortcount.i32(x[pend])]) for r, x in zip(rows[:W], keys)],
                 torch.cat([rows[W], amt[pend]]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_t1_plain_rounds_on_card_never_tear_rows(dev):
    """The plain rounds on a CUDA tensor with hundreds of distinct W=13
    keys on one slot hash, twice: with one elected writer per slot no
    row is torn, so no key ends up in two slots."""
    from kaarme_tpu_torch.ops import cuda_table, table

    keys, valid, _ = _table_keys(400, 201, seed=3, dev=dev)
    h = torch.full(valid.shape, 5, dtype=torch.int64, device=dev)
    tk, cn = table.make_table(14, len(keys), dev)
    for _ in range(2):
        _, npend = cuda_table.table_insert_plain(tk, cn, keys, valid, h, max_probes=512)
        assert int(npend) == 0
    rows = _check_table_invariants(tk, cn, 512, lambda keys: torch.full_like(keys[0], 5))
    assert rows.shape[1] > 100
    assert int(rows[-1].sum()) == 2 * int(valid.sum())


def _k3_columns(rows):
    """(n, W) int64 key rows -> W int32 columns laid out as K3 writes
    them: the rows of one (W, n) buffer."""
    return tuple(sortcount.i32(rows.T.contiguous()).unbind(0))


def _t1_case(case, dev):
    """Key columns of one T1 card case and its table size and probes."""
    from kaarme_tpu_torch.ops import windows

    n = 1 << 16
    if case in ("poly_a", "ac_repeat"):
        k = 51
        codes = torch.zeros(n + k - 1, dtype=torch.int32, device=dev)
        if case == "ac_repeat":
            codes[1::2] = 1                       # ACAC...: two keys in alternate lanes
        keys, valid, _ = windows.windows_with_hash(codes.view(1, -1), k)
        return _k3_columns(torch.stack(keys, 1)), 12, 64
    if case == "near_equal":
        # per warp 8 keys of 4 lanes each; keys that share a warp differ
        # in ONE word (word 0, 1 or 3), and warps repeat every 64
        i = torch.arange(n, device=dev)
        lane, warp = i % 32, (i // 32) % 64
        base = torch.stack([warp * 0x9E3779B1, warp * 0x85EBCA6B, warp * 0xC2B2AE35 + 7,
                            (warp % 8) << 26], 1) & 0xFFFFFFFF
        flip = torch.stack([lane & 1, (lane >> 1) & 1, lane * 0, ((lane >> 2) & 1) << 30], 1)
        return _k3_columns(base ^ flip), 14, 64
    k = int(case.split("_")[1])                   # overfull_k: 2^8 slots, max_probes 8
    keys, valid, _ = _table_keys(4000, k, seed=k, dev=dev)
    rows = torch.stack(keys, 1).masked_fill(~valid[:, None], 0xFFFFFFFF)
    return _k3_columns(rows), 8, 8


@pytest.mark.cuda
@pytest.mark.parametrize("amount", [False, True], ids=["ones", "amounts"])
@pytest.mark.parametrize("case", ["poly_a", "ac_repeat", "near_equal", "overfull_13",
                                  "overfull_51", "overfull_201"])
def test_t1_derived_equals_plain(dev, case, amount):
    """T1 from K3-shaped key columns alone (valid and h derived in the
    kernel, equal keys aggregated per warp) == the plain version (torch
    validity and hash_words, then the probe rounds): the same stored
    (key row, count) multiset where nothing is pending; in overfull
    tables stored + pending == input per key on both; no key in two
    slots and lookup (the hash_words chain) finds every stored key."""
    from kaarme_tpu_torch.ops import cuda_table, table

    keys, cap_log2, max_probes = _t1_case(case, dev)
    W = len(keys)
    valid = sortcount._is_sentinel_i32(keys) == 0
    g = torch.Generator(device=dev).manual_seed(W)
    amt = (torch.randint(1, 6, valid.shape, generator=g, device=dev, dtype=torch.int32)
           if amount else torch.ones(valid.shape, dtype=torch.int32, device=dev))
    runs = []
    for run in (cuda_table.table_insert, cuda_table.table_insert_plain):
        tk, cn = table.make_table(cap_log2, W, dev)
        pend, npend = run(tk, cn, keys, amount=amt if amount else None, max_probes=max_probes)
        torch.cuda.synchronize()
        assert int(npend) == int(pend.sum()) and not (pend & ~valid).any()
        rows = _check_table_invariants(tk, cn, max_probes)

        def totals(cols, a):
            uk, inv = torch.unique(torch.stack([sortcount.i32(c) for c in cols]), dim=1,
                                   return_inverse=True)
            return uk, torch.zeros(uk.shape[1], dtype=torch.int64, device=dev).index_add_(
                0, inv, a.long())

        want = totals([x[valid] for x in keys], amt[valid])
        got = totals([torch.cat([r, x[pend]]) for r, x in zip(rows[:W], keys)],
                     torch.cat([rows[W], amt[pend]]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        runs.append((rows, int(npend)))
    if case.startswith("overfull"):
        assert runs[0][1] > 0 and runs[1][1] > 0
    else:
        assert runs[0][1] == runs[1][1] == 0 and torch.equal(runs[0][0], runs[1][0])
        if case in ("poly_a", "ac_repeat"):
            assert runs[0][0].shape[1] == (1 if case == "poly_a" else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [13, 51])
def test_table_count_step_hashes_on_card(dev, k):
    """The table route's count step on the card launches K3 and T1 once
    and makes no host hash (``hash_words``) call; its table == the plain
    step's."""
    from kaarme_tpu_torch.models import sort_counter
    from kaarme_tpu_torch.ops import cuda_table, cuda_winkeys, hashing, table

    n = 1 << 14
    flat = _codes(n, k, seed=k).clip(0, 4).astype(np.uint8)
    words, bits, m = sort_counter.pack_chunk(flat, n)
    out = []
    for kernels in ("cuda", "plain"):
        chunk = dict(packed=sort_counter.to_device(words, dev),
                     sep=sort_counter.to_device(bits, dev), k=k, n=m)
        hashing.hash_words.calls = 0
        cuda_table.table_insert.launches = cuda_winkeys.window_keys.launches = 0
        tk, cn, ov, pend = table.count_step(*table.make_table(16, (k + 15) // 16, dev),
                                            kernels=kernels, **chunk)
        torch.cuda.synchronize()
        if kernels == "cuda":
            assert hashing.hash_words.calls == 0
            assert cuda_table.table_insert.launches == cuda_winkeys.window_keys.launches == 1
        assert int(ov) == 0 and not pend.any()
        out.append(_table_multiset(tk, cn))
    assert torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_table_counter_grows_on_card_as_plain(dev):
    """Forced growth (migration through T1 with amount = stored count):
    kernels == plain, grow events equal."""
    from kaarme_tpu_torch.models.counter import CounterConfig, KmerCounter

    codes = np.random.default_rng(8).integers(0, 4, 5000).astype(np.uint8)
    out = []
    for kernels in ("cuda", "plain"):
        c = KmerCounter(CounterConfig(k=21, min_slots=256, tile=256, batch_tiles=4,
                                      kernels=kernels, min_abundance=1)).count_codes(codes)
        tk, cn = c.dump()
        order = np.lexsort(tk.T[::-1])
        out.append((tk[order].tolist(), cn[order].tolist(), c.stats["grow_events"]))
    assert out[0] == out[1] and out[0][2] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [["-s", "100000"], ["-b", "-u", "100000"]],
                         ids=["table", "table_bloom"])
def test_table_cli_kernels_equal_plain_route(dev, tmp_path, extra):
    from kaarme_tpu_torch.ops import cuda_table, cuda_winkeys

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 30_000)
    starts = rng.integers(0, 30_000 - 150, 2000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r.fa", "wb") as f:
        for i, s0 in enumerate(starts):
            f.write(b">r%d\n%s\n" % (i, lut[genome[s0:s0 + 150]].tobytes()))
    from kaarme_tpu_torch.ops import cuda_bloom

    a, b = tmp_path / "k.txt", tmp_path / "p.txt"
    argv = [str(tmp_path / "r.fa"), "31", "-a", "1", "-q", "--backend", "table"] + extra
    cuda_table.table_insert.launches = cuda_winkeys.window_keys.launches = 0
    cuda_bloom.bloom_insert.launches = cuda_bloom.bloom_gate.launches = 0
    assert cli.main(argv + ["-o", str(a)]) == 0
    assert cuda_table.table_insert.launches > 0 and cuda_winkeys.window_keys.launches > 0
    bloom = "-b" in extra
    assert (cuda_bloom.bloom_insert.launches > 0) == (cuda_bloom.bloom_gate.launches > 0) == bloom
    cuda_table.table_insert.launches = cuda_winkeys.window_keys.launches = 0
    assert cli.main(argv + ["-o", str(b), "--kernels", "plain"]) == 0
    assert cuda_table.table_insert.launches == cuda_winkeys.window_keys.launches == 0
    assert sorted(a.read_bytes().splitlines()) == sorted(b.read_bytes().splitlines())
    if "-b" not in extra:
        counts = [int(ln.split()[1]) for ln in a.read_bytes().splitlines()]
        assert sum(counts) == 2000 * (150 - 31 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sort", "merge", "skm", "table"])
def test_two_shards_on_one_card_equal_cpu_shards(dev, route):
    """Two shards on cuda:0 (the kernels, the exchange as same-device
    copies) equal two CPU shards (the plain versions), record for
    record on every shard."""
    from kaarme_tpu_torch import parallel

    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 2850, 400)
    codes = np.concatenate([np.append(genome[s:s + 150], 4) for s in starts])
    runs = {}
    for devices in ((dev, dev), ("cpu", "cpu")):
        if route == "table":
            cfg = parallel.ShardedCounterConfig(k=31, min_slots=1 << 12, tile=1024,
                                                batch_tiles=8, max_probes=16)
            c = parallel.ShardedKmerCounter(cfg, devices).count_codes(codes)
            tk, cn = c._host_table()
            per = tk.shape[0] // 2
            shards = []
            for d in range(2):
                occ = cn[d * per:(d + 1) * per] > 0
                shards.append(sorted(zip(map(tuple, tk[d * per:(d + 1) * per][occ].tolist()),
                                         cn[d * per:(d + 1) * per][occ].tolist())))
            runs[devices[0]] = (shards, c.stats["grow_events"])
            continue
        kw = dict(k=31, batch_windows=1 << 13, prefix_cap=1 << 12)
        if route == "skm":
            c = parallel.ShardedSkmCounter(parallel.ShardedSkmConfig(skm_slots=16, **kw), devices)
        else:
            c = parallel.ShardedSortCounter(parallel.ShardedSortConfig(
                compactor="merge" if route == "merge" else "auto", **kw), devices)
        c.count_codes(codes)
        shards = [(keys.tobytes(), cnt.tobytes()) for keys, cnt in c.shard_dumps()]
        # timings, host syncs and kernel launches differ between devices; every
        # other statistic agrees
        runs[devices[0]] = (shards, {key: v for key, v in c.stats.items()
                                     if not key.endswith("_seconds")
                                     and key not in ("host_syncs", "expand_launches")})
    assert runs[dev] == runs["cpu"]


def _w1_part(k, n, seed, dev, cnt_dtype=torch.int32, layout="store"):
    """n rows of random key words and counts over the digit boundaries,
    16383/16384, 65535/65536/131072 and dead rows, on the card: key
    columns as a store's rows ((W + 1, n) buffer: li = 1) or as a table's
    slot rows ((n, W) buffer: li = W)."""
    rng = np.random.default_rng(seed)
    W = (k + 15) // 16
    edges = [0, 1, 9, 10, 99, 100, 999, 1000, 9999, 10000, 16383, 16384, 65535, 65536, 131072]
    cnt = rng.choice(edges + list(range(1, 40)), n).astype(np.int64)
    words = rng.integers(0, 1 << 32, (W, n), dtype=np.uint64).astype(np.uint32).view(np.int32)
    if layout == "store":
        buf = torch.from_numpy(np.concatenate([words, cnt[None].astype(np.int32)])).to(dev)
        keys = tuple(buf[:W].unbind(0))
    else:
        buf = torch.from_numpy(np.ascontiguousarray(words.T)).to(dev)
        keys = tuple(buf.unbind(1))
    return keys, torch.from_numpy(cnt).to(dev, cnt_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["store", "table"])
@pytest.mark.parametrize("k,n", [(2, 1025), (13, 1 << 16), (16, 1023), (17, 1024), (33, 1),
                                 (51, 300_000), (201, 5000)])
def test_w1_equals_plain(dev, k, n, layout):
    """W1 == its plain version on the card, byte for byte and line count,
    in both modes, int32 and int64 counts, thresholds -1, 0 and 2."""
    from kaarme_tpu_torch.ops import writer

    for cnt_dtype in (torch.int32, torch.int64):
        keys, cnt = _w1_part(k, n, k + n, dev, cnt_dtype, layout)
        for mode in (0, 2):
            for abu in (-1, 0, 2):
                kw = dict(k=k, mode=mode, min_abundance=abu)
                launches = writer.format_lines.launches
                got, lines = writer.format_lines(keys, cnt, **kw)
                want, want_lines = writer.format_lines_plain(keys, cnt, **kw)
                torch.cuda.synchronize()
                assert writer.format_lines.launches == launches + 1
                assert got.device.type == "cuda"
                assert lines == want_lines and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["store", "table"])
def test_w1_lines_longer_than_a_window(dev, layout):
    """k=40,000: every line spans windows of W1's 16 KB staging buffer."""
    from kaarme_tpu_torch.ops import writer

    keys, cnt = _w1_part(40_000, 100, 7, dev, layout=layout)
    got, lines = writer.format_lines(keys, cnt, k=40_000, mode=2, min_abundance=1)
    want, want_lines = writer.format_lines_plain(keys, cnt, k=40_000, mode=2, min_abundance=1)
    assert lines == want_lines > 0 and torch.equal(got, want)


@pytest.mark.cuda
def test_w1_empty_parts(dev):
    """No rows (no launch), and every row dead or filtered: empty text."""
    from kaarme_tpu_torch.ops import writer

    keys, cnt = _w1_part(51, 0, 1, dev)
    launches = writer.format_lines.launches
    text, lines = writer.format_lines(keys, cnt, k=51, mode=2, min_abundance=1)
    assert text.numel() == lines == 0 and writer.format_lines.launches == launches
    keys, cnt = _w1_part(51, 3000, 2, dev)
    for c, abu in ((torch.zeros_like(cnt), -1), (cnt.clamp(max=5), 6)):
        text, lines = writer.format_lines(keys, c, k=51, mode=2, min_abundance=abu)
        assert text.numel() == lines == 0


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_lines", [1, 7, 1000, None])
def test_w1_chunked_write_equals_plain(dev, tmp_path, chunk_lines):
    """write_lines on the card (W1, the pinned host buffer) in chunks of
    1, 7 and 1000 lines' budget and in one piece, over several parts,
    == the plain route's file."""
    from kaarme_tpu_torch.ops import writer

    k = 31
    parts = [_w1_part(k, n, n, dev, layout=lay)
             for n, lay in ((2500, "store"), (0, "store"), (1, "table"), (4097, "table"))]
    budget = writer.CHUNK_BYTES if chunk_lines is None else chunk_lines * writer.line_bytes(k)
    a, b = tmp_path / "k.txt", tmp_path / "p.txt"
    kw = dict(k=k, mode=0, min_abundance=0, chunk_bytes=budget)
    writer.format_lines.launches = 0
    n = writer.write_lines(str(a), parts, **kw)
    assert writer.format_lines.launches >= 3
    writer.format_lines.launches = 0
    assert writer.write_lines(str(b), parts, kernels="plain", **kw) == n
    assert writer.format_lines.launches == 0
    assert a.read_bytes() == b.read_bytes() and a.read_bytes().count(b"\n") == n > 6000


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--pipeline", "classic"], ["--backend", "table"]],
                         ids=["skm", "classic", "table"])
def test_cli_writes_through_w1(dev, tmp_path, extra):
    """Every route's count file is assembled by W1 on the card (and by
    the plain version under --kernels plain: no launch), byte for byte
    the same (the table's sorted)."""
    from kaarme_tpu_torch.ops import writer

    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, 30_000)
    starts = rng.integers(0, 30_000 - 150, 2000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r.fa", "wb") as f:
        for i, s0 in enumerate(starts):
            f.write(b">r%d\n%s\n" % (i, lut[genome[s0:s0 + 150]].tobytes()))
    a, b = tmp_path / "k.txt", tmp_path / "p.txt"
    argv = [str(tmp_path / "r.fa"), "31", "-s", "100000", "-m", "0", "-a", "1", "-q"] + extra
    writer.format_lines.launches = 0
    assert cli.main(argv + ["-o", str(a)]) == 0
    assert writer.format_lines.launches >= 1
    writer.format_lines.launches = 0
    assert cli.main(argv + ["-o", str(b), "--kernels", "plain"]) == 0
    assert writer.format_lines.launches == 0
    assert sorted(a.read_bytes().splitlines()) == sorted(b.read_bytes().splitlines())
    if "table" not in extra:
        assert a.read_bytes() == b.read_bytes()


def _read_chunk(n, k, seed, genome_len, poly_a=False):
    """The transfer chunk (2-bit words, bitmap) of n windows of reads
    of max(150, 2k) bases sampled (from ``seed``) from one random genome of
    ``genome_len`` bases, a separator after each read; ``poly_a``: n + k -
    1 A's, no separator."""
    rng = np.random.default_rng(seed)
    L = n + k - 1
    if poly_a:
        bases, inv = np.zeros(L, np.uint8), np.zeros(L, bool)
    else:
        rl = max(150, 2 * k)
        genome = np.random.default_rng(genome_len).integers(0, 4, genome_len).astype(np.uint8)
        starts = rng.integers(0, genome_len - rl, -(-L // (rl + 1)))
        reads = np.concatenate([genome[starts[:, None] + np.arange(rl)],
                                np.full((starts.shape[0], 1), 4, np.uint8)], 1).reshape(-1)[:L]
        bases, inv = np.where(reads == 4, 0, reads).astype(np.uint8), reads == 4
    packed, _ = fastio.pack_stream_np(bases)
    _, mask = fastio.pack_stream_np(inv.astype(np.uint8) * 4)
    return packed, mask


# (k, n, filter bits, genome length): the table batch at the CLI's -u
# 5000000 sizing (2^28 bits), a 2^10-bit filter under heavy collision,
# poly-A (one root 2^20 times), k=201, and a tail n of no whole block
_BLOOM_CASES = {"table_k51": (51, 1 << 20, 1 << 28, 200_000),
                "small_filter": (31, 100_000, 1 << 10, 50_000),
                "poly_a": (51, 1 << 20, 1 << 20, 0),
                "k201": (201, 100_003, 1 << 20, 30_000),
                "tail": (13, 777, 1 << 16, 2_000)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_BLOOM_CASES))
def test_b1_equals_plain(dev, case):
    """B1 (the pass-1 insert) against its plain version over three
    batches of K3 key columns, each version updating its own filters from
    the same start: equal BF1 and BF2 words and counters after every
    batch; one scratch serves every batch; no host synchronisation."""
    from kaarme_tpu_torch.ops import bloom, cuda_bloom

    k, n, bits, glen = _BLOOM_CASES[case]
    kf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    pf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    scratch = cuda_bloom.scratch_for(n, dev)
    cuda_bloom.bloom_insert.launches = 0
    for b in range(3):
        packed, mask = _read_chunk(n, k, seed=b, genome_len=glen, poly_a=case == "poly_a")
        keys = cuda_winkeys.window_keys(_dev(packed, dev), _dev(mask, dev), k=k, n=n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = cuda_bloom.bloom_insert(kf[0], kf[1], keys, 7, scratch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = cuda_bloom.bloom_insert_plain(pf[0], pf[1], keys, 7)
        assert [int(x) for x in got] == [int(x) for x in want]
        assert torch.equal(kf[0], pf[0]) and torch.equal(kf[1], pf[1])
    assert cuda_bloom.bloom_insert.launches == 3
    assert int(pf[1].ne(0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["300_batches", "epoch_wrap", "in_both_filters"])
def test_b1_one_scratch_over_batches(dev, case):
    """B1 against its plain version batch after batch on ONE scratch, whose
    set is never cleared between batches (each takes the next epoch), no
    host synchronisation: 300 batches of 2^14 k=31 windows into 2^16-bit
    filters, every 50th a poly-A batch (one root 2^14 times); a run of
    three batches at epochs 1-3 that then jumps to EPOCH_MAX - 2 and
    wraps (the batches after the wrap meet the slots epochs 1-3 left, so
    the set must be cleared at the wrap); and one batch of 2^16 k=51
    windows three times, the first on empty filters, the third with
    every key already in both (counters 0, filters unchanged)."""
    from kaarme_tpu_torch.ops import bloom, cuda_bloom

    k, n, bits, glen, seeds = {"300_batches": (31, 1 << 14, 1 << 16, 300_000, range(300)),
                               "epoch_wrap": (51, 1 << 16, 1 << 22, 200_000, range(9)),
                               "in_both_filters": (51, 1 << 16, 1 << 22, 200_000, [5] * 3)}[case]
    kf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    pf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    scratch = cuda_bloom.scratch_for(n, dev)
    cuda_bloom.bloom_insert.launches = 0
    counters = []
    for b, seed in enumerate(seeds):
        if case == "epoch_wrap" and b == 3:
            scratch.epoch = cuda_bloom.EPOCH_MAX - 2
        packed, mask = _read_chunk(n, k, seed=seed, genome_len=glen, poly_a=b % 50 == 49)
        keys = cuda_winkeys.window_keys(_dev(packed, dev), _dev(mask, dev), k=k, n=n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = cuda_bloom.bloom_insert(kf[0], kf[1], keys, 7, scratch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = cuda_bloom.bloom_insert_plain(pf[0], pf[1], keys, 7)
        counters.append([int(x) for x in want])
        assert [int(x) for x in got] == counters[-1], (b, scratch.epoch)
        assert torch.equal(kf[0], pf[0]) and torch.equal(kf[1], pf[1]), (b, scratch.epoch)
    assert cuda_bloom.bloom_insert.launches == len(seeds)
    if case == "epoch_wrap":
        assert scratch.epoch == 4
    if case == "in_both_filters":
        assert counters[0][0] > 0 and counters[2] == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["k3", "separate"])
@pytest.mark.parametrize("case", list(_BLOOM_CASES))
def test_b2_equals_plain(dev, case, layout):
    """B2 (the pass-2 gate) against its plain version on K3 key columns
    gated by a BF2 that holds the keys of the batch before: equal key
    words (missed keys all-ones, invalid ones still all-ones); in place
    on K3's buffer.  k=13, 51 and 201, tails of no whole block (777 and
    100,003 windows)."""
    from kaarme_tpu_torch.ops import bloom, cuda_bloom

    k, n, bits, glen = _BLOOM_CASES[case]
    bf1, bf2 = bloom.make_bloom(bits, dev), bloom.make_bloom(bits, dev)
    batches = [_read_chunk(n, k, seed=b, genome_len=glen, poly_a=case == "poly_a")
               for b in range(2)]
    keys = [cuda_winkeys.window_keys(_dev(p, dev), _dev(m, dev), k=k, n=n)
            for p, m in batches]
    cuda_bloom.bloom_insert(bf1, bf2, keys[0], 7)
    cuda_bloom.bloom_insert(bf1, bf2, keys[0], 7)      # every key of batch 0 in BF2
    cols = keys[1] if layout == "k3" else tuple(x.clone() for x in keys[1])
    want = cuda_bloom.bloom_gate_plain(bf2, tuple(x.clone() for x in cols), 7)
    cuda_bloom.bloom_gate.launches = 0
    got = cuda_bloom.bloom_gate(bf2, cols, 7)
    assert cuda_bloom.bloom_gate.launches == 1
    if layout == "k3":
        assert all(g.data_ptr() == c.data_ptr() for g, c in zip(got, cols))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _runs_on(dev, R, k, seed, negative=True):
    from expand_rows import run_rows

    return tuple(torch.from_numpy(c).to(dev) for c in run_rows(R, k, seed, negative))


@pytest.mark.cuda
@pytest.mark.parametrize("k,R", [(k, R) for k in (16, 17, 31, 32, 33, 48, 51, 63, 101, 201)
                                 for R in (0, 1, 33, 1001)]
                         + [(51, 1 << 20), (201, 1 << 16), (257, 1001), (300, 4099)])
def test_e1_equals_plain(dev, k, R):
    """E1 against its plain version (``skm.expand_runs_plain`` on the
    card), bit for bit: separate columns (stacked by the wrapper) and
    views of one buffer (read where they lie), no multiple of 32 runs or
    of a block, the main path's 2^20-run chunk at k=51, and W > 16."""
    from kaarme_tpu_torch.ops import cuda_expand, skm

    cols = _runs_on(dev, R, k, seed=k + R)
    want = skm.expand_runs_plain(cols, k)
    buf = torch.stack(cols)
    for layout in (cols, tuple(buf.unbind(0))):
        cuda_expand.expand_runs.launches = 0
        got = cuda_expand.expand_runs(layout, k)
        assert cuda_expand.expand_runs.launches == int(R > 0)
        assert len(got) == len(want) == (k + 15) // 16 + 1
        for a, b in zip(got, want):
            assert a.device == b.device and torch.equal(a, b)
        if R:
            assert all(g.untyped_storage().data_ptr() == got[0].untyped_storage().data_ptr()
                       for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("bloom", [False, True], ids=["no_bloom", "bloom"])
@pytest.mark.parametrize("chunked", [False, True], ids=["single_shot", "chunked"])
def test_e1_finalize_store_equals_plain(dev, monkeypatch, chunked, bloom):
    """``skm.finalize_store`` on the card under ``kernels="cuda"`` (E1,
    then B2 with a filter, sort and K2) equals its ``kernels="plain"``
    result: one shot, and chunks of 256 runs into an accumulator that
    regrows; E1 runs once per chunk attempt and the plain chain never."""
    from kaarme_tpu_torch.ops import cuda_expand, skm
    from kaarme_tpu_torch.utils import trace

    k = 51
    cols = _runs_on(dev, 5003, k, seed=5, negative=False)
    kw = dict(chunk_rows=256, single_shot_rows=0) if chunked else {}
    if bloom:
        words = np.random.default_rng(6).integers(0, 1 << 32, 1 << 10, dtype=np.uint64)
        kw.update(bloom=_dev(words.astype(np.uint32), dev), hfn=2)
    want, nd_want = skm.finalize_store(cols, k, kernels="plain", **kw)
    cuda_expand.expand_runs.launches = 0
    stats = {}
    monkeypatch.setattr(skm, "_expand_keys", None)     # the plain chain must not run
    with trace.span("finalize", stats):
        got, nd = skm.finalize_store(cols, k, kernels="cuda", **kw)
    assert nd == nd_want > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cuda_expand.expand_runs.launches == stats["expand_launches"] == stats["finalize_chunks"]
    if chunked:
        assert stats["finalize_regrows"] >= 1
    if bloom:
        full, nd_full = skm.finalize_store(cols, k, kernels="cuda")
        assert 0 < nd < nd_full
        # the gated rows are E1's buffer: B2 gates its key rows and the
        # counts are zeroed in its count row, with no column beside it
        rows = skm.expand_chunk(cols, k, kw["bloom"], 2)
        assert all(c.untyped_storage().data_ptr() == rows[0].untyped_storage().data_ptr()
                   for c in rows)


@pytest.mark.cuda
def test_e1_launches_equal_finalize_chunks_of_a_job(dev):
    """A small SkmCounter job on the card: ``expand_launches`` in its
    stats equals ``finalize_chunks`` and E1's launch count, and its
    finalized store equals the ``kernels="plain"`` job's."""
    from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig
    from kaarme_tpu_torch.ops import cuda_expand

    rng = np.random.default_rng(12)
    genome = rng.integers(0, 4, 50_000).astype(np.uint8)
    starts = rng.integers(0, 50_000 - 150, 4000)
    reads = np.full((4000, 151), 4, np.uint8)
    reads[:, :150] = genome[starts[:, None] + np.arange(150)]
    codes = reads.reshape(-1)
    kw = dict(k=51, min_abundance=1, batch_windows=1 << 16, superbatch_batches=2,
              prefix_cap=1 << 16)
    cuda_expand.expand_runs.launches = 0
    c = SkmCounter(SkmCounterConfig(device="cuda", **kw)).count_codes(codes)
    got = c.dump()
    assert c.stats["finalize_chunks"] >= 1
    assert cuda_expand.expand_runs.launches == c.stats["expand_launches"] \
        == c.stats["finalize_chunks"]
    p = SkmCounter(SkmCounterConfig(device="cuda", kernels="plain", **kw)).count_codes(codes)
    assert cuda_expand.expand_runs.launches == c.stats["finalize_chunks"]
    assert "expand_launches" not in p.stats
    for a, b in zip(got, p.dump()):
        assert np.array_equal(a, b)
    assert int(got[1].sum()) == 4000 * (150 - 51 + 1)
