"""Streaming input of the port (its copy of ``kaarme_tpu/io/reader.py``):
format sniffing, chunked (optionally gzip) reading, and an async
prefetch pipeline feeding the device.

- format sniffing by gzip magic + first content byte
  (reference: main.cpp:19-68);
- chunked reads; the k-1 overlap between chunks is carried in *code
  space* by the consumer (reference: include/text_reader.h:206-213 seeks
  back k-1 raw symbols);
- a producer thread + bounded queue replaces the reference's io_worker /
  ts_queue machinery (reference: include/parallel_parser.hpp:1230-1299,
  include/ts_queue.h).
"""

from __future__ import annotations

import gzip
import queue
import threading

from ..utils import trace
from . import fastio

DEFAULT_CHUNK_BYTES = 8 << 20  # mirrors the reference's 8 MiB read buffer


class FormatError(ValueError):
    pass


def sniff_format(path: str):
    """Returns (fmt, gzipped) with fmt in {'fasta', 'fastq', 'plain'}.

    Unlike the reference — which detects FASTQ but rejects it
    (include/parallel_parser.hpp:1217-1225 'Not implemented yet') — this
    framework counts FASTQ directly (sequence lines only).
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    gzipped = magic[:2] == b"\x1f\x8b"
    opener = gzip.open if gzipped else open
    with opener(path, "rb") as f:
        first = f.read(1)
    if not first:
        raise FormatError(f"input file {path} is empty")
    c = first[:1]
    if c == b">":
        return "fasta", gzipped
    if c == b"@":
        return "fastq", gzipped
    return "plain", gzipped


class CodeChunkReader:
    """Iterates encoded code chunks of a file; no overlap logic here
    (the consumer keeps the k-1 carry — see models/sort_counter.py)."""

    def __init__(self, path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES, fmt=None, gzipped=None):
        self.path = path
        self.chunk_bytes = int(chunk_bytes)
        if fmt is None or gzipped is None:
            fmt, gzipped = sniff_format(path)
        self.fmt = fmt
        self.gzipped = gzipped

    def __iter__(self):
        opener = gzip.open if self.gzipped else open
        in_header = False
        fq_state = None
        with opener(self.path, "rb") as f:
            while True:
                with trace.span("read"):
                    buf = f.read(self.chunk_bytes)
                if not buf:
                    break
                with trace.span("encode"):
                    if self.fmt == "fasta":
                        codes, in_header = fastio.encode_fasta(buf, in_header)
                    elif self.fmt == "fastq":
                        codes, fq_state = fastio.encode_fastq(buf, fq_state)
                    else:
                        codes = fastio.encode_plain(buf)
                if codes.shape[0]:
                    yield codes


class PrefetchingReader:
    """Background-thread wrapper so file read + encode overlaps device work.

    Bounded queue depth mirrors the reference's ``active_chunks``
    (reference: main.cpp:386).
    """

    _SENTINEL = object()

    def __init__(self, inner, depth: int = 4):
        self.inner = inner
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []

        def produce():
            try:
                for item in self.inner:
                    q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            with trace.span("reader_wait"):
                item = q.get()
            if item is self._SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
