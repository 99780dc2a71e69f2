"""The record exchange of the sharded counters: every shard sends each of
its records to the shard that owns it — the port's counterpart of the
``shard_map`` + ``all_to_all`` bodies of ``kaarme_tpu/parallel/``
(``sharded_sort.py``, ``sharded_skm.py``, ``sharded.py``), written once.

One process drives every shard, so the exchange is a set of tensor
copies: a source shard orders its live records by owner (a stable sort,
so each bucket keeps the source order), takes the bucket sizes from one
``bincount``, and copies each bucket to its owner's device
(``non_blocking``); the owner concatenates what it receives in source
order.  Only live records travel: the JAX package's sentinel-filled
``ndev x cap`` send buffers are a static-shape workaround that a
variable-length copy does not need.  A device may appear several times
in ``devices`` (several shards on one card); the copies are then
same-device copies and the routing is unchanged.
"""

from __future__ import annotations

import torch

from ..ops.hashing import hash_words


def owner_by_hash(keys, ndev: int) -> torch.Tensor:
    """Owner shard of each key row of the sort and skm stores: the top
    log2(ndev) bits of the murmur hash of its k-mer words (int64)."""
    return hash_words(keys) >> (32 - (ndev - 1).bit_length())


def exchange(shard_cols, owners, devices) -> list:
    """Route records to their owners.

    ``shard_cols[s]`` is a sequence of equal-length 1-D tensors on
    ``devices[s]`` (the live records of shard s, one tensor per field);
    ``owners[s]`` is the owner shard of each record (integer tensor on
    the same device).  Returns, for every shard d, the tuple of fields of
    the records that d owns, on ``devices[d]``: shard 0's bucket first,
    then shard 1's, each in its source order."""
    ndev = len(devices)
    if len(shard_cols) != ndev or len(owners) != ndev:
        raise ValueError(f"{len(shard_cols)} shards of records for {ndev} devices")
    buckets = [[] for _ in range(ndev)]           # buckets[dst] in source order
    for cols, owner in zip(shard_cols, owners):
        order = torch.sort(owner, stable=True).indices
        sizes = torch.bincount(owner, minlength=ndev).tolist()
        parts = [torch.split(c[order], sizes) for c in cols]
        for dst in range(ndev):
            buckets[dst].append(tuple(
                p[dst].to(devices[dst], non_blocking=True) for p in parts))
    return [tuple(torch.cat(field) for field in zip(*received)) for received in buckets]
