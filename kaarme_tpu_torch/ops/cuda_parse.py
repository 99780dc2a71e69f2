"""P1: FASTA or plain-text bytes to the counters' transfer chunk, on the
device.  The JAX package encodes and packs its input on the host
(``kaarme_tpu/io/fastio.py``: ``encode_fasta`` / ``encode_plain``, then
``pack_stream``); this is that step moved behind the copy of the file's
raw bytes.

``parse_pack`` launches the hand-written kernel (``csrc/parse_pack.cu``)
on CUDA tensors and runs the plain PyTorch version,
``parse_pack_plain``, on CPU tensors or under ``kernels="plain"``.

Contract (both versions).  A code stream has global positions from 0; the
chunk of superstep s holds positions [s sb, s sb + span), span = sb + k -
1, as ``sort_counter.pack_chunk``'s dense form of those codes: int32
2-bit words (ceil(span / 16); base i at bits 2 (i % 16) of word i / 16)
and int32 bitmap words (ceil(span / 32); bit i % 32 of word i / 32 set
where position i holds code 4), zeroed before the stream reaches them.
``parse_pack(raw, ...)`` appends the codes that ``fastio.encode_fasta``
(``fasta=True``, with the header state carried across blocks) or
``encode_plain`` gives for the bytes of ``raw`` (a 1-d uint8 tensor on
the device) at the stream's offset, into ``chunks``: the (words, bitmap)
pairs of supersteps base, base + 1, ...  Every chunk that a code of the
block lands in must be listed; one that is not sets ``state``'s error
flag (read by the host with the offset).  The offset and the header
state live in ``ParseState``, on the device: no call waits on the host.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from .sortcount import i32, u32


class ParseState:
    """A code stream's carried state on ``device``: ``buf`` (int64) holds
    two slots of [code offset, header state] and the error flag; a call
    reads slot ``slot`` and writes the other, so a launch never reads what
    it writes.  The kernel's pointer table and scratch are kept here,
    allocated on the stream that is current at the first call."""

    def __init__(self, device):
        self.buf = torch.zeros(5, dtype=torch.int64, device=device)
        self.slot = 0
        self._tab_key = None
        self._tab = None
        self._scratch = None

    def host_view(self, vals) -> tuple:
        """(code offset, header state, error flag) from ``buf``'s values."""
        return vals[2 * self.slot], vals[2 * self.slot + 1], vals[4]

    def _table(self, chunks) -> torch.Tensor:
        """The chunks' pointers as a device int64 tensor, made again only
        when the chunks change."""
        key = tuple(t.data_ptr() for pair in chunks for t in pair)
        if key != self._tab_key:
            self._tab = torch.tensor(key, dtype=torch.int64).pin_memory().to(
                self.buf.device, non_blocking=True)
            self._tab_key = key
        return self._tab

    def _scratch_for(self, nb: int) -> torch.Tensor:
        need = int(_build.lib().kt_parse_pack_scratch(nb))
        if self._scratch is None or self._scratch.shape[0] < need:
            self._scratch = torch.empty(need, dtype=torch.uint8, device=self.buf.device)
        return self._scratch


def _check(raw, chunks, sb: int, span: int):
    if raw.dtype != torch.uint8 or raw.dim() != 1:
        raise ValueError("raw must be a 1-d uint8 tensor")
    if raw.shape[0] >= 1 << 30:
        raise ValueError("a block must be shorter than 2^30 bytes")
    if sb <= 0 or sb % 32 or span < sb:
        raise ValueError("sb must be a positive multiple of 32 and span >= sb")
    if not chunks:
        raise ValueError("no chunk to write to")
    for words, bits in chunks:
        if words.dtype != torch.int32 or bits.dtype != torch.int32:
            raise ValueError("chunks must be int32 tensors")
        if words.shape[0] < -(-span // 16) or bits.shape[0] < -(-span // 32):
            raise ValueError(f"a chunk of {span} codes needs {-(-span // 16)} words "
                             f"and {-(-span // 32)} bitmap words")
        if words.device != raw.device or bits.device != raw.device:
            raise ValueError("raw and the chunks must be on one device")


def parse_pack(raw: torch.Tensor, *, fasta: bool, state: ParseState, chunks, base: int,
               sb: int, span: int, kernels: str = "cuda") -> None:
    """Append the codes of ``raw`` to the stream (module docstring): P1 on
    the card, the plain version on the CPU or under ``kernels="plain"``."""
    _check(raw, chunks, sb, span)
    if raw.shape[0] == 0:
        return
    if kernels == "plain" or raw.device.type == "cpu":
        parse_pack_plain(raw, fasta=fasta, state=state, chunks=chunks, base=base, sb=sb,
                         span=span)
    elif raw.device.type == "cuda":
        dev = raw.device
        tab = state._table(chunks)
        scratch = state._scratch_for(raw.shape[0])
        p = state.buf.data_ptr()
        with torch.cuda.device(dev):
            err = _build.lib().kt_parse_pack(
                raw.data_ptr(), raw.shape[0], int(bool(fasta)), p + 16 * state.slot,
                p + 16 * (1 - state.slot), p + 32, scratch.data_ptr(), tab.data_ptr(), base,
                len(chunks), sb, span, torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "kt_parse_pack")
        parse_pack.launches += 1
    else:
        raise ValueError(f"unsupported device {raw.device}")
    trace.count("device_parsed_bytes", raw.shape[0])
    state.slot = 1 - state.slot


parse_pack.launches = 0

_LUTS = {}


def _lut(device) -> torch.Tensor:
    """byte -> code (A/C/G/T either case 0-3, else 4), int64 on ``device``."""
    key = str(device)
    if key not in _LUTS:
        lut = torch.full((256,), 4, dtype=torch.int64)
        for i, ch in enumerate(b"ACGT"):
            lut[ch] = lut[ch + 32] = i
        _LUTS[key] = lut.to(device)
    return _LUTS[key]


def _or_into(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, ok: torch.Tensor):
    """OR the int64 bits ``val`` into int32 words ``dst[idx]`` where ``ok``
    (the bits of one word never overlap: their sum is their OR)."""
    n = dst.shape[0]
    idx = torch.where(ok, idx, n)
    acc = torch.zeros(n + 1, dtype=torch.int64, device=dst.device).index_add_(0, idx, val)
    dst.copy_(i32(u32(dst) | acc[:n]))


def parse_pack_plain(raw: torch.Tensor, *, fasta: bool, state: ParseState, chunks, base: int,
                     sb: int, span: int) -> None:
    """P1's plain version (module docstring), on ``state``'s device, with no
    host synchronisation; it leaves ``state.slot`` to the caller."""
    st = state.buf
    dev = st.device
    b = raw.to(dev, torch.int64)
    nb = b.shape[0]
    off, hin = st[2 * state.slot], st[2 * state.slot + 1]
    code = _lut(dev)[b]
    if fasta:
        nl, gt = b == 10, b == 62
        ev = torch.where(gt, 1, torch.where(nl, 0, -1))
        idx = torch.arange(nb, device=dev)
        last = torch.cummax(torch.where(ev >= 0, idx, -1), 0).values  # last event at or before
        prev = torch.cat([last.new_full((1,), -1), last[:-1]])
        inside = torch.where(prev >= 0, ev[prev.clamp(min=0)], hin)      # header state before
        emit = torch.where(inside == 1, nl, ~(nl | gt))
        code = torch.where(inside == 1, 4, code)
        h_out = torch.where(last[-1] >= 0, ev[last[-1].clamp(min=0)], hin)
    else:
        emit = torch.ones(nb, dtype=torch.bool, device=dev)
        h_out = hin.clone()
    e = emit.to(torch.int64)
    pos = off + torch.cumsum(e, 0) - e
    for i, (words, bits) in enumerate(chunks):
        lp = pos - (base + i) * sb
        ok = emit & (lp >= 0) & (lp < span)
        _or_into(words, lp >> 4, torch.where(ok & (code < 4), code << (2 * (lp & 15)), 0), ok)
        _or_into(bits, lp >> 5, torch.where(ok & (code == 4), 1 << (lp & 31), 0), ok)
    sup = torch.div(pos, sb, rounding_mode="floor")
    bad = emit & ((sup < base) | (sup >= base + len(chunks)))
    ns = 1 - state.slot
    st[4] = torch.maximum(st[4], bad.any().to(torch.int64))
    st[2 * ns] = off + e.sum()
    st[2 * ns + 1] = h_out
