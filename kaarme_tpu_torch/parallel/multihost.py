"""Multi-host (multi-process) counting — the counterpart of
``kaarme_tpu/parallel/multihost.py``.

One process per host, each driving its local device list with the
sharded sort counter (``sharded_sort.py``); ``torch.distributed`` is the
leg between processes:

- **input sharding is byte-span based**: host h owns the windows whose
  first base lies in file bytes [h*size/H, (h+1)*size/H), reads ONLY
  that span plus a forward halo of k-1 codes (the cross-host version of
  the reference's k-1 chunk back-seek, include/text_reader.h:206-213),
  and never sends codes to another host;
- **lockstep rounds**: every round, each process says whether it still
  has windows (one scalar ``all_reduce`` over the host group); a process
  whose span is exhausted feeds an all-separator round, which counts no
  window, so every process calls every collective the same number of
  times.  Growth decisions take the global maximum of the shards'
  ``nd_used`` (``_global_max``): a local decision that leads to a
  collective would deadlock;
- **the only record traffic** is the finalize exchange of distinct
  records (``exchange.exchange_processes``): device tensors on NCCL, or
  through pinned host memory on gloo (``--dist-backend gloo``, which is
  how two processes share one card).  Host scalars (the round flag, the
  maxima, the bucket sizes) always ride a gloo group, so the per-round
  flag costs no device sync.

The global shard count (processes x local devices) must be a power of
two: a record's owner is the top log2 bits of its key hash, and any
other count would leave owners without a shard.

Launcher: every host runs

    python -m kaarme_tpu_torch.parallel.multihost INPUT KLEN \\
        --coordinator HOST0:PORT --num-processes H --process-id h \\
        -s SLOTS -o OUT [--merge-parts]

and writes its hash partition to ``OUT.part{h}`` (``--merge-parts``
merges them into OUT on a shared filesystem; the parts are disjoint).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import gzip
import heapq
import os
import sys
import warnings
from contextlib import ExitStack

import numpy as np
import torch
import torch.distributed as dist

from ..io import fastio
from ..io import reader as io_reader
from ..models.sort_counter import CountOutput, rows_to_host, store_part
from ..ops.sortcount import next_store_size
from ..utils import codec, trace
from ..utils.convert import store_from_numpy
from .exchange import exchange_processes
from .sharded import make_mesh
from .sharded_sort import ShardedSortConfig, ShardedSortCounter

DEFAULT_CHUNK_BYTES = io_reader.DEFAULT_CHUNK_BYTES
DEFAULT_TIMEOUT_S = 1800.0


# ---------------------------------------------------------------------------
# Runtime init
# ---------------------------------------------------------------------------

def check_shard_count(nproc: int, nloc: int) -> None:
    """Refuse a global shard count that is not a power of two (the
    message ``make_mesh`` gives, with the layout)."""
    n = nproc * nloc
    if n < 1 or n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n} "
                         f"({nproc} processes x {nloc} devices)")


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group: ``tcp://coordinator``, world size
    ``num_processes``, rank ``process_id``.

    Arguments default to the KAARME_COORDINATOR / KAARME_NUM_PROCS /
    KAARME_PROC_ID environment variables.  ``backend`` is ``"gloo"``
    (CPU processes, or cards staged through host memory) or ``"nccl"``;
    an init that fails raises, it never falls back to another backend."""
    coordinator = coordinator or os.environ.get("KAARME_COORDINATOR")
    if num_processes is None and "KAARME_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["KAARME_NUM_PROCS"])
    if process_id is None and "KAARME_PROC_ID" in os.environ:
        process_id = int(os.environ["KAARME_PROC_ID"])
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("multi-host counting needs --coordinator, --num-processes and "
                         "--process-id (or KAARME_COORDINATOR, KAARME_NUM_PROCS and "
                         "KAARME_PROC_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} out of range for {num_processes} processes")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's part of the global 1-D mesh: its local ``devices``
    are global shards ``pid * nloc .. pid * nloc + nloc - 1``."""
    devices: tuple
    pid: int
    nproc: int
    host_group: object      # gloo group of the host scalars (None: the default group)
    staged: bool            # records cross on gloo from cards: stage in pinned memory

    @property
    def nloc(self) -> int:
        return len(self.devices)

    @property
    def shard_ids(self) -> range:
        return range(self.pid * self.nloc, (self.pid + 1) * self.nloc)


def global_mesh(n_devices: int = 0, device: str = "cuda") -> ProcessMesh:
    """This process's local devices (``make_mesh(n_devices, device)``)
    and its global shard ids, in an initialized process group.  Every
    process must call it: it creates the gloo group of the host scalars
    and the NCCL communicator when the main backend is NCCL, and checks
    with one ``all_gather``
    that every process built its device list, with the same number of
    devices, and that the global shard count is a power of two; every
    process raises the same error otherwise."""
    backend = dist.get_backend()
    host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    try:
        devices = make_mesh(n_devices, device)
        if backend == "nccl" and devices[0].type != "cuda":
            raise ValueError("the nccl backend needs --device cuda")
        problem = None
    except ValueError as e:
        devices, problem = (), e
    nproc = dist.get_world_size()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(counts, torch.tensor([len(devices)]), group=host_group)
    counts = [int(c) for c in counts]
    if problem is not None:
        raise problem
    if 0 in counts:
        raise ValueError(f"process {counts.index(0)} could not build its device list")
    if len(set(counts)) != 1:
        raise ValueError(f"every process needs the same number of local devices, got {counts}")
    check_shard_count(nproc, counts[0])
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    if backend == "nccl":
        # NCCL makes its communicator at the first call: make it now, so
        # that a failing NCCL init fails before any counting
        dist.all_reduce(torch.zeros(1, device=devices[0]))
    return ProcessMesh(devices, dist.get_rank(), nproc, host_group,
                       staged=backend == "gloo" and devices[0].type == "cuda")


# ---------------------------------------------------------------------------
# Per-host input spans
# ---------------------------------------------------------------------------

def _find_line_start(f, pos: int, block: int = 1 << 16) -> int:
    """Byte offset of the first character of the line containing pos."""
    while pos > 0:
        lo = max(0, pos - block)
        f.seek(lo)
        buf = f.read(pos - lo)
        j = buf.rfind(b"\n")
        if j >= 0:
            return lo + j + 1
        pos = lo
    return 0


def _find_fastq_record_start(f, pos: int, size: int, block: int = 1 << 20) -> int:
    """Byte offset of the first FASTQ record start at or after pos.

    A line is a record start iff it begins with '@' and the line two
    below begins with '+' (4-line FASTQ).  The '@' byte also occurs in
    quality strings, but a quality line q has q+1 = header and q+2 =
    sequence, and sequences never begin with '+', so the test cannot
    fire on a quality line."""
    if pos == 0:
        return 0
    start = _find_line_start(f, pos)
    f.seek(start)
    buf = b""
    base = start
    while True:
        more = f.read(block)
        if more:
            buf += more
        # line offsets within buf (buf always starts at a line start)
        offs = [0]
        j = buf.find(b"\n")
        while j >= 0:
            offs.append(j + 1)
            j = buf.find(b"\n", j + 1)
        # candidate line i and line i+2 must be COMPLETE in buf
        for i in range(len(offs) - 3):
            if buf[offs[i]: offs[i] + 1] == b"@" and buf[offs[i + 2]: offs[i + 2] + 1] == b"+":
                return base + offs[i]
        if not more:
            return size
        # drop fully scanned lines, keep the last 3 partial candidates
        if len(offs) > 3:
            cut = offs[-3]
            base += cut
            buf = buf[cut:]


class HostSpanReader:
    """Encoded code chunks for ONE host's byte span of a shared input.

    Ownership contract: the union over hosts of the windows produced
    from each host's (span + forward halo) equals the single-host window
    multiset, each window exactly once.

    - span: bytes [h*size/H, (h+1)*size/H); encoding starts there, so the
      first code is the first base at or after the span start (a FASTA
      span starting inside a header line resumes in skip-header state,
      found by one backward line scan);
    - forward halo: after the span, encoding continues until k-1 codes
      were collected OR a separator code appears (a separator kills
      every window that reaches it, so nothing after it can matter);
      windows never *start* in the halo, because a length-L code stream
      gives L-k+1 windows;
    - FASTQ spans are record-aligned: host h owns the records starting
      in its byte span (the encoder separates records, so no halo);
    - gzip input is refused (no random access): ``--presplit`` it.
    """

    def __init__(self, path: str, host_id: int, num_hosts: int, k: int,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES, fmt: str | None = None,
                 gzipped: bool | None = None):
        if not 0 <= host_id < num_hosts:
            raise ValueError("host_id out of range")
        if fmt is None or gzipped is None:
            fmt, gzipped = io_reader.sniff_format(path)
        if gzipped:
            raise ValueError(
                "multi-host gzip input is not supported (gzip has no random access): run "
                "kaarme_tpu_torch.parallel.multihost --presplit to produce per-host "
                "record-aligned parts, or decompress first")
        self.path, self.fmt, self.k = path, fmt, k
        self.chunk_bytes = int(chunk_bytes)
        size = os.path.getsize(path)
        self.begin = host_id * size // num_hosts
        self.end = (host_id + 1) * size // num_hosts
        self.size = size
        if fmt == "fastq":
            with open(path, "rb") as f:
                self.begin = _find_fastq_record_start(f, self.begin, size)
                self.end = _find_fastq_record_start(f, self.end, size) \
                    if self.end < size else size

    def _encode(self, buf: bytes, in_header: bool):
        if self.fmt == "fasta":
            return fastio.encode_fasta(buf, in_header)
        return fastio.encode_plain(buf), False

    def __iter__(self):
        if self.fmt == "fastq":
            yield from self._iter_fastq()
            return
        with open(self.path, "rb") as f:
            in_header = False
            if self.fmt == "fasta" and self.begin > 0:
                f.seek(_find_line_start(f, self.begin))
                # a span starting inside a header line stays in
                # skip-until-newline state (the '>' owner emits the
                # separator of this record boundary)
                in_header = f.read(1) == b">"
            f.seek(self.begin)
            remaining = self.end - self.begin
            while remaining > 0:
                buf = f.read(min(self.chunk_bytes, remaining))
                if not buf:
                    break
                remaining -= len(buf)
                codes, in_header = self._encode(buf, in_header)
                if codes.shape[0]:
                    yield codes
            if self.end >= self.size:
                return
            # forward halo: k-1 codes, or up to the first separator
            need = self.k - 1
            halo = []
            while need > 0:
                buf = f.read(min(self.chunk_bytes, 1 << 20))
                if not buf:
                    break
                codes, in_header = self._encode(buf, in_header)
                if not codes.shape[0]:
                    continue
                seps = np.flatnonzero(codes[:need] >= codec.SEP)
                if seps.size:
                    halo.append(codes[: seps[0] + 1])
                    break
                take = codes[:need]
                halo.append(take)
                need -= take.shape[0]
            if halo:
                yield np.concatenate(halo)

    def _iter_fastq(self):
        """The record-aligned span [begin, end), through the stateful
        FASTQ encoder (the span ends at the next host's first record)."""
        state = codec.FASTQ_STATE0
        with open(self.path, "rb") as f:
            f.seek(self.begin)
            remaining = self.end - self.begin
            while remaining > 0:
                buf = f.read(min(self.chunk_bytes, remaining))
                if not buf:
                    break
                remaining -= len(buf)
                codes, state = fastio.encode_fastq(buf, state)
                if codes.shape[0]:
                    yield codes


def presplit(path: str, num_hosts: int, out_prefix: str, block_records: int = 4096) -> list:
    """Split a (possibly gzipped) FASTA/FASTQ/plain input into
    ``num_hosts`` record-aligned part files ``out_prefix.host{h}``, for
    multi-host runs where byte spans cannot work (gzip has no random
    access).  One streaming pass deals records to the parts in
    round-robin blocks of ``block_records``; every record boundary is a
    window separator, so no count changes.  Returns the part paths."""
    fmt, gzipped = io_reader.sniff_format(path)
    opener = gzip.open if gzipped else open
    paths = [f"{out_prefix}.host{h}" for h in range(num_hosts)]
    with ExitStack() as stack:
        outs = [stack.enter_context(open(p, "wb")) for p in paths]
        f = stack.enter_context(opener(path, "rb"))
        h = 0
        nrec = 0
        if fmt == "fastq":
            while True:
                rec = [f.readline() for _ in range(4)]
                if not rec[0]:
                    break
                if not all(rec) or not rec[2].startswith(b"+"):
                    # a partial 4-line record would corrupt the part
                    warnings.warn(f"presplit: dropping truncated FASTQ tail record in {path!r}")
                    break
                outs[h].writelines(rec)
                nrec += 1
                if nrec % block_records == 0:
                    h = (h + 1) % num_hosts
        elif fmt == "fasta":
            cur = None
            for line in f:
                if line.startswith(b">"):
                    # rotate when a block completes, as the other formats do
                    if nrec and nrec % block_records == 0:
                        h = (h + 1) % num_hosts
                    nrec += 1
                    cur = h
                if cur is not None:
                    outs[cur].write(line)
        else:
            for line in f:
                outs[h].write(line)
                nrec += 1
                if nrec % block_records == 0:
                    h = (h + 1) % num_hosts
    return paths


def host_span_codes(path: str, host_id: int, num_hosts: int, k: int, **kw) -> np.ndarray:
    """This host's whole encoded stream (span + halo)."""
    chunks = list(HostSpanReader(path, host_id, num_hosts, k, **kw))
    return np.concatenate(chunks) if chunks else np.empty(0, np.uint8)


def merge_parts(out_path: str, num_parts: int, buf_bytes: int = 1 << 22) -> int:
    """Streaming k-way merge of the part files ``out_path.part{h}`` into
    ``out_path``.  Each part is sorted (key order == ACGT string order)
    and the parts are disjoint, so a heap merge holds one line per part.
    Returns the number of lines."""
    n = 0
    with ExitStack() as stack:
        files = [stack.enter_context(open(f"{out_path}.part{h}", "rb", buffering=buf_bytes))
                 for h in range(num_parts)]
        out = stack.enter_context(open(out_path, "wb", buffering=buf_bytes))
        for line in heapq.merge(*files):
            out.write(line)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Multi-host counter
# ---------------------------------------------------------------------------

class MultiHostSortCounter(ShardedSortCounter):
    """``ShardedSortCounter`` over this process's local devices, in lockstep
    with the other processes of the group.

    Streaming is host-local (each host's devices count its byte span);
    the per-round flag, the global maxima and the finalize exchange are
    the only collectives.  After the exchange this process holds the
    records of its global shards: its partition of the distinct set,
    disjoint from every other process's."""

    def __init__(self, config: ShardedSortConfig, mesh: ProcessMesh | None = None):
        self.mesh = mesh if mesh is not None else global_mesh()
        self.pid, self.nproc, self.nloc = self.mesh.pid, self.mesh.nproc, self.mesh.nloc
        super().__init__(config, self.mesh.devices)
        self.stats["exchange_bytes"] = 0

    # -- collectives ---------------------------------------------------------

    def _global_max(self, x: int) -> int:
        t = torch.tensor([x], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.host_group)
        return int(t)

    def _exchange(self, cols) -> list:
        owners = self._owners(cols, self.nproc * self.nloc)
        recv, nbytes = exchange_processes(cols, owners, self.mesh)
        self.stats["exchange_bytes"] += nbytes
        return recv

    # -- counting --------------------------------------------------------------

    def count_file(self, path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES, prefetch: int = 4):
        """Count this host's byte span of ``path`` (lockstep with peers)."""
        chunks = HostSpanReader(path, self.pid, self.nproc, self.cfg.k, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        return self.count_codes_stream(iter(chunks))

    def count_codes(self, codes: np.ndarray):
        """Count THIS host's span codes (lockstep rounds with peers)."""
        return self.count_codes_stream(iter([np.asarray(codes, np.uint8)]))

    def count_codes_stream(self, chunks):
        """Rounds of ``nloc x batch_windows`` windows until no process has
        a window left: each round, one ``all_reduce`` of the "have" flag,
        then the round (padded with separators) through ``_submit``."""
        if self._exchanged:
            raise RuntimeError("cannot add input after finalize")
        with trace.span("count", self.stats):
            k = self.cfg.k
            sb = self.nloc * self.cfg.batch_windows      # this host's windows per round
            pending, pending_n, exhausted = [], 0, False
            while True:
                while not exhausted and pending_n < sb + k - 1:
                    c = next(chunks, None)
                    if c is None:
                        exhausted = True
                        break
                    pending.append(np.asarray(c, np.uint8))
                    pending_n += pending[-1].shape[0]
                have = 1 if pending_n >= k else 0
                if self._global_max(have) == 0:
                    break
                stream = np.concatenate(pending) if pending else np.empty(0, np.uint8)
                n_real = max(stream.shape[0] - k + 1, 0) if have else 0
                span = np.full(sb + k - 1, codec.SEP, np.uint8)
                m = min(stream.shape[0], span.shape[0])
                span[:m] = stream[:m]
                leftover = stream[sb:]
                pending = [leftover] if leftover.shape[0] else []
                pending_n = int(leftover.shape[0])
                self._submit(span, min(n_real, sb))
            self._merge()
        return self

    def add_codes(self, codes: np.ndarray):
        raise RuntimeError("multi-host counting is round-driven: use count_file / count_codes")

    def finish(self):
        raise RuntimeError("multi-host counting is round-driven: use count_file / count_codes")

    # -- output ------------------------------------------------------------------

    def dump_local(self):
        """This host's hash partition of the distinct set (``dump``: keys
        (N, W) uint32 sorted, counts (N,) int64, from one key range a local
        device).  Partitions are disjoint across hosts."""
        return self.dump()

    def write_output_part(self, path: str) -> int:
        """Write this host's partition to ``path.part{pid}``."""
        return self.write_output(f"{path}.part{self.pid}")

    def as_dict_local(self) -> dict:
        """This host's partition as {kmer: count} (disjoint across hosts;
        their union is the global answer)."""
        return CountOutput.as_dict(self)

    def find(self, kmers):
        raise NotImplementedError(
            "find() on a multi-host counter sees only this host's hash-partition; query the "
            "merged output file, or run find on each host and take the nonzero answer")

    def as_dict(self) -> dict:
        raise NotImplementedError(
            "as_dict() would return only this host's partition; use as_dict_local() "
            "(disjoint across hosts) or write_output_part() + merge_parts()")

    # -- checkpoint / resume (the kaarme_tpu multihost_sort .npz parts) -------

    def save(self, path: str):
        """Per-process checkpoint part: this process's shards' records
        (before the exchange, so a key may hold partial counts on several
        shards and parts; ``load`` sums them) to ``path.part{pid}.npz``.
        Every process calls ``save`` at the same round boundary (between
        ``count_codes`` / ``count_file`` calls, before finalize).  The
        part is written to a temporary name, then renamed; ``save``
        returns once every process's part is in place."""
        if self._exchanged:
            raise RuntimeError("cannot checkpoint after finalize")
        self._merge()
        keys, counts = rows_to_host([store_part(p, nd) for p, nd in zip(self.prefix, self._nd)])
        tmp = f"{path}.part{self.pid}.tmp.npz"
        np.savez_compressed(
            tmp, kind="multihost_sort", k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance,
            keys=keys, counts=counts,
            windows_processed=self.stats["windows_processed"], num_parts=self.nproc)
        os.replace(tmp, f"{path}.part{self.pid}.npz")
        dist.barrier(group=self.mesh.host_group)

    @classmethod
    def load(cls, path: str, config: ShardedSortConfig | None = None,
             mesh: ProcessMesh | None = None):
        """Restore ``save`` parts of either package onto the current
        processes (any count).  Every process calls ``load``; parts are
        dealt round-robin by process id, and the per-shard capacity is
        derived from all part sizes, so every process sizes its stores
        alike without a collective."""
        z0 = np.load(f"{path}.part0.npz")
        if "kind" not in z0.files or str(z0["kind"]) != "multihost_sort":
            raise ValueError(f"{path}.part0.npz is not a multi-host checkpoint")
        num_parts = int(z0["num_parts"])
        k = int(z0["k"])
        if config is None:
            config = ShardedSortConfig(k=k, mode=int(z0["mode"]),
                                       min_abundance=int(z0["min_abundance"]))
        elif config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config, mesh)
        w = config.words
        rows_of = [int(np.load(f"{path}.part{h}.npz")["counts"].shape[0])
                   for h in range(num_parts)]
        need = max(sum(rows_of[p::self.nproc]) for p in range(self.nproc)) or 1
        while -(-need // self.nloc) > self.cfg.prefix_cap:
            self.cfg.prefix_cap = next_store_size(self.cfg.prefix_cap + 1)
        keys_l, cnt_l, wins = [], [], 0
        for h in range(self.pid, num_parts, self.nproc):
            z = np.load(f"{path}.part{h}.npz")
            keys_l.append(z["keys"].astype(np.uint32).reshape(-1, w))
            cnt_l.append(z["counts"].astype(np.int64))
            wins += int(z["windows_processed"])
        keys = np.concatenate(keys_l) if keys_l else np.zeros((0, w), np.uint32)
        cnt = np.concatenate(cnt_l) if cnt_l else np.zeros(0, np.int64)
        if keys.shape[0]:
            # sum partial counts, sort: each store is sorted, one row per key
            order = np.lexsort(keys.T[::-1])
            keys, cnt = keys[order], cnt[order]
            first = np.ones(keys.shape[0], bool)
            first[1:] = (keys[1:] != keys[:-1]).any(axis=1)
            starts = np.flatnonzero(first)
            cnt = np.add.reduceat(cnt, starts)
            keys = keys[starts]
        per = -(-max(keys.shape[0], 1) // self.nloc)
        self.prefix, self._nd = [], []
        for d, dev in enumerate(self.devices):
            part = slice(d * per, (d + 1) * per)
            cols = [keys[part, j] for j in range(w)] + [cnt[part]]
            self.prefix.append(store_from_numpy(cols, self.cfg.prefix_cap, dev))
            self._nd.append(int(cols[0].shape[0]))
        self.stats["windows_processed"] = wins
        return self


def multihost_load(path: str, config: ShardedSortConfig | None = None,
                   mesh: ProcessMesh | None = None) -> MultiHostSortCounter:
    """Restore a multi-host counter from per-process ``save`` parts
    (every process calls this; see ``MultiHostSortCounter.load``)."""
    return MultiHostSortCounter.load(path, config, mesh)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kaarme_tpu_torch.parallel.multihost",
        description="Multi-host canonical k-mer counting (one process per host)")
    ap.add_argument("INPUT")
    ap.add_argument("KLEN", type=int)
    ap.add_argument("--coordinator", default=None,
                    help="host0 address:port (or KAARME_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; an error without a card) or 'cpu'")
    ap.add_argument("--devices", type=int, default=0,
                    help="local shards per process (0: every visible card, or 1 on the CPU)")
    ap.add_argument("--kernels", default="cuda", choices=("cuda", "plain"),
                    help="'cuda': the hand-written kernels (their plain versions on CPU "
                         "tensors); 'plain': the plain PyTorch versions everywhere")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="records between processes: nccl (default with --device cuda) "
                         "or gloo (the default on the CPU; from cards, staged through "
                         "pinned host memory: two processes on one card)")
    ap.add_argument("-s", "--hash-tab-size", type=int, default=0)
    ap.add_argument("-m", "--hash-table-type", type=int, default=2)
    ap.add_argument("-a", "--min-k-abu", type=int, default=2)
    ap.add_argument("-o", "--output-file", required=True)
    ap.add_argument("--batch-log2", type=int, default=20)
    ap.add_argument("--merge-parts", action="store_true",
                    help="after counting, process 0 merges all part files "
                         "(requires a shared filesystem)")
    ap.add_argument("--presplit", type=int, default=0, metavar="H",
                    help="do not count: split INPUT (gzip ok) into H record-aligned "
                         "part files next to -o and exit")
    return ap


def config(args, nshards: int) -> ShardedSortConfig:
    """The counter's configuration for the launcher's arguments over
    ``nshards`` global shards: ``-s`` sizes the distinct store like the
    reference's table size, split over the GLOBAL shard count
    (``prefix_cap`` is per shard); growth covers underestimates."""
    cap = 1 << max(10, args.batch_log2 - 2)
    if args.hash_tab_size:
        cap = max(cap, next_store_size(-(-args.hash_tab_size // nshards)))
    return ShardedSortConfig(k=args.KLEN, mode=args.hash_table_type, min_abundance=args.min_k_abu,
                             batch_windows=1 << args.batch_log2, prefix_cap=cap,
                             kernels=args.kernels)


def _layout(args):
    """(process count, local device count, backend) from the arguments,
    checked before connecting: raises ValueError / RuntimeError."""
    nproc = args.num_processes
    if nproc is None and "KAARME_NUM_PROCS" in os.environ:
        nproc = int(os.environ["KAARME_NUM_PROCS"])
    if nproc is None or nproc < 1:
        raise ValueError("--num-processes (or KAARME_NUM_PROCS) must be >= 1")
    kind = torch.device(args.device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but torch.cuda.is_available() "
                           "is False (pass --device cpu to run the plain CPU path)")
    if kind == "cpu":
        nloc = args.devices or 1
    elif kind == "cuda":
        nloc = args.devices or torch.cuda.device_count()
    else:
        raise ValueError(f"unsupported device {args.device!r} (use 'cuda' or 'cpu')")
    check_shard_count(nproc, nloc)
    backend = args.dist_backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda")
    fmt, gzipped = io_reader.sniff_format(args.INPUT)
    if gzipped:
        raise ValueError(f"{args.INPUT}: multi-host gzip input is not supported (gzip has no "
                         "random access): split it with --presplit H, or decompress first")
    return nproc, nloc, backend


def run(argv=None):
    """Parse, count this host's span, write its part (and merge the
    parts); returns (exit code, counter or None)."""
    args = build_parser().parse_args(argv)
    if args.presplit:
        print("\n".join(presplit(args.INPUT, args.presplit, args.output_file)))
        return 0, None
    try:
        nproc, nloc, backend = _layout(args)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    try:
        init_distributed(args.coordinator, nproc, args.process_id, backend)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    try:
        try:
            mesh = global_mesh(nloc, args.device)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1, None
        c = MultiHostSortCounter(config(args, mesh.nproc * mesh.nloc), mesh)
        c.count_file(args.INPUT)
        c.finalize_exchange()
        n = c.write_output_part(args.output_file)
        print(f"host {c.pid}/{c.nproc}: {n} k-mers -> {args.output_file}.part{c.pid}",
              flush=True)
        if args.merge_parts:
            dist.barrier(group=mesh.host_group)
            if c.pid == 0:
                with trace.span("merge", c.stats):
                    total = merge_parts(args.output_file, c.nproc)
                print(f"merged {total} k-mers -> {args.output_file}", flush=True)
            dist.barrier(group=mesh.host_group)
        return 0, c
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
