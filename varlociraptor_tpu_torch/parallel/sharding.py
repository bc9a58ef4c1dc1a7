"""Locus sharding over devices and processes (torch port of
``varlociraptor_tpu/parallel/sharding.py``).

A :class:`LocusMesh` stands where the JAX package has a ``jax.sharding.Mesh``
over the ``"loci"`` axis: the ordered shard devices of this process and, in a
multi-process run, the ``torch.distributed`` process group.  The engine's
locus batch is padded to the local shard count and split into one block per
shard; each shard runs the port's engine on its device (one engine copy per
distinct device), every shard is launched before any is fetched, and the
padding is stripped on the host.  The loci are independent, so the forward
pass needs no collective: a rank evaluates its own rows.  The one collective
is :func:`all_gather_rows`, the bit-exact float64 gather behind global FDR
over region shards (``filtration.fdr.control_fdr_sharded``).

Multi-process runs read ``torchrun``'s environment (:func:`distributed_mesh`):
NCCL when every rank has a card of its own, gloo on the CPU, and gloo on the
card only when asked for (ranks that share one card).
"""

from __future__ import annotations

import copy
import os
import weakref

import numpy as np
import torch

from ..device import resolve_device


class LocusMesh:
    """The shards of this process along the mesh's one axis, ``"loci"``.

    ``devices``: the shard devices in shard order; a device may appear more
    than once, and its shards then run one after another (the CPU tests run
    ``["cpu"] * 8``).  ``group``: the process group of a multi-process run
    (None in one process), with this process's ``rank`` in ``world_size``
    ranks over ``backend``; every rank has the same number of shards, and the
    global shard order is rank-major.  ``collective_device``: where the
    gathers run (the rank's card under NCCL, the CPU under gloo)."""

    def __init__(self, devices, group=None, rank=0, world_size=1,
                 backend=None, collective_device=None):
        if not devices:
            raise ValueError("a LocusMesh needs at least one shard device")
        self.devices = [resolve_device(d) for d in devices]
        self.group = group
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.collective_device = collective_device
        self._engines = weakref.WeakKeyDictionary()

    @property
    def n_local(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of every process."""
        return self.n_local * self.world_size

    def engine_on(self, engine, device):
        """``engine`` on ``device``: the engine itself where it lives, else a
        copy with its tables moved there, built once per mesh, engine and
        device."""
        if engine.device == device:
            return engine
        copies = self._engines.setdefault(engine, {})
        if device not in copies:
            eng = copy.copy(engine)
            eng._to_device(device)
            copies[device] = eng
        return copies[device]

    def __repr__(self):
        where = "" if self.group is None else (
            f", rank {self.rank} of {self.world_size} over {self.backend}")
        return f"LocusMesh({[str(d) for d in self.devices]}{where})"


def _cards():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "locus_mesh(): no CUDA card (torch.cuda.is_available() is False); "
            "pass the devices to shard on the CPU, e.g. locus_mesh(['cpu'] * 8)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def locus_mesh(devices=None) -> LocusMesh:
    """One shard per device; by default one per visible CUDA card.  Without
    a card it raises: the CPU is used only when it is asked for."""
    return LocusMesh(_cards() if devices is None else devices)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, 0
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths), pad


def shard_engine_inputs(mesh: LocusMesh, *arrays):
    """Pad the locus axis of every array to a multiple of this process's
    shard count (zero rows) and split it into one block per local shard.
    Returns ([per shard: [block of each array]], pad).

    Multi-process: each process passes its OWN block of loci, and every
    process passes a block of the same size (the JAX package's contract,
    which lays the global batch out rank-major in equal blocks).  No rank
    reads another's rows: the engine needs no collective."""
    blocks, pad = [], 0
    for arr in arrays:
        padded, pad = pad_to_multiple(np.asarray(arr), mesh.n_local, axis=0)
        blocks.append(np.split(padded, mesh.n_local, axis=0))
    return [list(shard) for shard in zip(*blocks)], pad


def _fetch_rows(engine, pending, L):
    """Fetch every shard, concatenate in shard order and strip the padding.
    Every output is per locus, so the rows are those of one ``engine.run``."""
    parts = [engine.fetch_run(p) for p in pending]
    return {k: np.concatenate([p[k] for p in parts], axis=0)[:L] for k in parts[0]}


def _split(mesh, arrays):
    """``shard_engine_inputs`` of the arrays that are not None; a None stays
    None in every shard."""
    present = [a for a in arrays if a is not None]
    shards, _ = shard_engine_inputs(mesh, *present)
    out = []
    for shard in shards:
        it = iter(shard)
        out.append([None if a is None else next(it) for a in arrays])
    return out


def run_sharded(engine, mesh, feats, mask, bias_alt, bias_ref, bias_any,
                combo_active, branch_gates, ln_prior_absent,
                n_artifact_active=None):
    """Run a PosteriorEngine over a locus batch split across the mesh's
    shards (this process's rows): every shard's ``run(..., fetch=False)`` is
    launched before any is fetched.  Returns host numpy outputs with the
    keys of ``engine.run()``, padding stripped."""
    L = np.asarray(feats).shape[0]
    shards = _split(mesh, [feats, mask, bias_alt, bias_ref, bias_any,
                           combo_active, branch_gates, ln_prior_absent,
                           n_artifact_active])
    pending = [
        mesh.engine_on(engine, dev).run(
            *a[:8], n_artifact_active=a[8], fetch=False
        )
        for dev, a in zip(mesh.devices, shards)
    ]
    return _fetch_rows(engine, pending, L)


def run_sharded_compact(engine, mesh, obs_f16, obs_u8, hil, mask, slot_map,
                        combo_active, branch_gates, ln_prior_absent,
                        fwd_rate, has_alt_loci, n_artifact_active=None):
    """Dense-compact twin of :func:`run_sharded`: the f16 / u8 / hil panels
    (ops.compact_obs) are split along the locus axis, and each shard runs
    ``engine.run_compact`` (feature expansion, bias factors and the
    posterior) on its device.  The columnar caller's route over a mesh; over
    a one-shard mesh it is the single-device run of the same program."""
    L = np.asarray(obs_f16).shape[0]
    shards = _split(mesh, [obs_f16, obs_u8, hil, mask, slot_map, combo_active,
                           branch_gates, ln_prior_absent, fwd_rate,
                           has_alt_loci, n_artifact_active])
    pending = [
        mesh.engine_on(engine, dev).run_compact(
            *a[:10], n_artifact_active=a[10], fetch=False
        )
        for dev, a in zip(mesh.devices, shards)
    ]
    return _fetch_rows(engine, pending, L)


def _rank_cards(local_rank, local_world):
    """This rank's cards: the host's cards dealt round-robin over its ranks,
    or, where the ranks outnumber the cards, the one card it shares."""
    n = len(_cards())
    if n >= local_world:
        return [torch.device("cuda", i) for i in range(local_rank, n, local_world)]
    return [torch.device("cuda", local_rank % n)]


def distributed_mesh(devices=None, backend=None) -> LocusMesh:
    """The mesh of a multi-process run, initialising ``torch.distributed``
    once from ``torchrun``'s environment: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (``LOCAL_WORLD_SIZE``, the
    ranks on this host, defaults to ``WORLD_SIZE``).  Without that
    environment it is :func:`locus_mesh` of ``devices``.

    ``devices``: this rank's shards; by default its cards (:func:`_rank_cards`).
    ``backend``: "nccl" (the default on the card) needs every rank on a card
    of its own; ranks that share one card must ask for "gloo", which is also
    the default when every shard is on the CPU.  Nothing falls back from one
    backend to another: a mismatch raises."""
    import torch.distributed as dist

    env = os.environ
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        return locus_mesh(devices)
    world = int(env["WORLD_SIZE"])
    rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if devices is None:
        devices = _rank_cards(local_rank, local_world)
    devices = [resolve_device(d) for d in devices]
    if backend is None:
        backend = "gloo" if all(d.type == "cpu" for d in devices) else "nccl"
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError(
                f"backend 'nccl' gathers on the card; this rank's shards are "
                f"{[str(d) for d in devices]}: use backend='gloo' on the CPU"
            )
        if local_world > torch.cuda.device_count():
            raise RuntimeError(
                f"backend 'nccl': {local_world} ranks on this host share "
                f"{torch.cuda.device_count()} card(s), and NCCL refuses two "
                "ranks on one card; pass backend='gloo'"
            )
        collective_device = devices[0]
    elif backend == "gloo":
        collective_device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported backend {backend!r} (use 'nccl' or 'gloo')")
    if dist.is_initialized():
        if dist.get_backend() != backend or dist.get_world_size() != world \
                or dist.get_rank() != rank:
            raise RuntimeError(
                f"torch.distributed is already initialised as rank "
                f"{dist.get_rank()} of {dist.get_world_size()} over "
                f"{dist.get_backend()}, not rank {rank} of {world} over {backend}"
            )
    else:
        if backend == "nccl":
            torch.cuda.set_device(collective_device)
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            world_size=world, rank=rank,
        )
    return LocusMesh(devices, group=dist.group.WORLD, rank=rank,
                     world_size=world, backend=backend,
                     collective_device=collective_device)


def all_gather_rows(local_rows: np.ndarray, mesh: LocusMesh):
    """Collective gather of per-shard row blocks -> the full array, in shard
    order, identical on every rank.

    The one cross-shard reduction of the pipeline (global FDR statistics):
    this process's rows are split into one block per local shard.  In one
    process each block goes to its shard's device and back, in order.  In a
    multi-process run a first gather agrees on every shard's row count;
    the blocks, zero-padded to the largest count as [n_local, max_rows, C],
    ride one gather on the group's device, and the rows are stripped by
    count and concatenated rank-major.  The values stay float64 from end to
    end, so the gather is bit-exact."""
    rows = np.asarray(local_rows, dtype=np.float64)
    C = rows.shape[1] if rows.ndim == 2 else 1
    blocks = [b.reshape(b.shape[0], C) for b in np.array_split(rows, mesh.n_local)]
    if mesh.group is None:
        out = np.concatenate(
            [torch.as_tensor(b).to(d).cpu().numpy() for b, d in zip(blocks, mesh.devices)],
            axis=0,
        )
        return out if rows.ndim == 2 else out[:, 0]
    import torch.distributed as dist

    dev = mesh.collective_device
    counts = torch.tensor([b.shape[0] for b in blocks], dtype=torch.int64, device=dev)
    all_counts = [torch.empty_like(counts) for _ in range(mesh.world_size)]
    dist.all_gather(all_counts, counts, group=mesh.group)
    all_counts = torch.cat(all_counts).cpu().numpy()
    max_rows = max(int(all_counts.max()), 1)
    stacked = np.zeros((mesh.n_local, max_rows, C), dtype=np.float64)
    for i, b in enumerate(blocks):
        stacked[i, : b.shape[0]] = b
    x = torch.as_tensor(stacked).to(dev)
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    full = torch.cat(parts).cpu().numpy()  # [world * n_local, max_rows, C]
    out = np.concatenate([full[i, :n] for i, n in enumerate(all_counts)], axis=0)
    return out if rows.ndim == 2 else out[:, 0]
