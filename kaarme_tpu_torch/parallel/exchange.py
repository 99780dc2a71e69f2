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

``exchange_processes`` is the same routing over several processes (the
multi-host counter, ``multihost.py``): the owners are global shard ids,
buckets for this process's shards are the same device copies, and the
buckets for each other process travel packed as one ``(n, fields)``
matrix in one ``all_to_all_single``, after one of the bucket sizes over
the host group.  Records go on the main group: device tensors on NCCL,
or through pinned host memory on gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


def exchange_processes(shard_cols, owners, mesh):
    """Route records to their owners across processes.

    ``mesh`` is this process's ``multihost.ProcessMesh``: its local
    ``devices`` hold global shards ``pid * nloc + s``.  ``shard_cols[s]``
    and ``owners[s]`` are as in ``exchange``, the owners global shard
    ids.  Every process calls this once per exchange (two collectives).
    Returns (for every local shard d, the tuple of fields of the records
    it owns on ``devices[d]``: global source shard 0's bucket first,
    each bucket in its source order; the bytes this process sent to and
    received from the others)."""
    devices, pid, nproc = mesh.devices, mesh.pid, mesh.nproc
    nloc = len(devices)
    if len(shard_cols) != nloc or len(owners) != nloc:
        raise ValueError(f"{len(shard_cols)} shards of records for {nloc} devices")
    nfield = len(shard_cols[0])
    dtype = shard_cols[0][0].dtype
    if any(c.dtype != dtype for cols in shard_cols for c in cols):
        raise ValueError("every field of the exchanged records must have one dtype")
    home = devices[0]
    sizes = torch.zeros((nloc, nproc * nloc), dtype=torch.int64)
    buckets = []                                  # buckets[s]: (n_s, fields) split by owner
    for s, (cols, owner) in enumerate(zip(shard_cols, owners)):
        order = torch.sort(owner, stable=True).indices
        size = torch.bincount(owner, minlength=nproc * nloc).cpu()
        sizes[s] = size
        buckets.append(torch.split(torch.stack([c[order] for c in cols], 1), size.tolist()))
    # sizes[s, q * nloc + d] travels to process q as [s, d]
    recv_sizes = torch.empty(nproc * nloc * nloc, dtype=torch.int64)
    dist.all_to_all_single(recv_sizes, sizes.view(nloc, nproc, nloc).transpose(0, 1)
                           .contiguous().view(-1), group=mesh.host_group)
    recv_sizes = recv_sizes.view(nproc, nloc, nloc)
    recv_sizes[pid] = 0                           # local buckets stay on the devices

    send = [buckets[s][q * nloc + d].to(home) for q in range(nproc) if q != pid
            for s in range(nloc) for d in range(nloc)]
    send = torch.cat(send) if send else torch.empty((0, nfield), dtype=dtype, device=home)
    send_rows = [0 if q == pid else int(sizes[:, q * nloc:(q + 1) * nloc].sum())
                 for q in range(nproc)]
    recv_rows = recv_sizes.sum(dim=(1, 2)).tolist()
    recv = torch.empty((sum(recv_rows), nfield), dtype=dtype, device=home)
    if mesh.staged:
        # gloo carries host tensors: stage both buffers in pinned memory
        host_send = torch.empty(send.shape, dtype=dtype, pin_memory=True)
        host_send.copy_(send)
        host_recv = torch.empty(recv.shape, dtype=dtype, pin_memory=True)
        dist.all_to_all_single(host_recv.view(-1), host_send.view(-1),
                               [n * nfield for n in recv_rows],
                               [n * nfield for n in send_rows])
        recv = host_recv.to(home, non_blocking=True)
    else:
        dist.all_to_all_single(recv.view(-1), send.view(-1),
                               [n * nfield for n in recv_rows],
                               [n * nfield for n in send_rows])
    remote = torch.split(recv, recv_sizes.view(-1).tolist())   # [p, s, d] order

    out = []
    for d, dev in enumerate(devices):
        got = []
        for p in range(nproc):
            for s in range(nloc):
                part = buckets[s][pid * nloc + d] if p == pid else \
                    remote[(p * nloc + s) * nloc + d]
                got.append(part.to(dev, non_blocking=True))
        out.append(tuple(torch.cat(got).t().contiguous().unbind(0)))
    nbytes = (send.numel() + recv.numel()) * send.element_size()
    return out, nbytes
