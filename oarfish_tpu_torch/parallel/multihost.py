"""Multi-process execution: the process group and the global shard layout.

Counterpart of the JAX package's `parallel/multihost.py`. Each process packs
its own reads (the same BAM, or its own part of them with `x.{proc}.bam`);
the shards of all processes make one global list of shard positions, and
the sharded EM of `sharded_em.py` runs with one all-reduce of the partial
transcript counts per m-step across them.

The process group is `torch.distributed` with the **gloo** backend, for the
host gathers (`allgather_hosts`) and for the per-iteration all-reduce
alike; gloo adds on the host, so a partial on the card goes there and back.
Process i runs its shard on `cuda:{i % device_count}` (every process shares
the one card of a one-card machine) or on the CPU with `--device cpu`. NCCL
is not used: it refuses two ranks on one card.

The JAX package's `assemble_global_shards` builds one global array from
each process's pieces (`jax.make_array_from_single_device_arrays`); it has
no counterpart, since here each process keeps its shards' tensors on its
own devices and only the partial counts cross between processes.
"""

from __future__ import annotations

import logging
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharded_em import ShardedCsr, ShardMesh, make_sharded_em, padded_init

log = logging.getLogger("oarfish_tpu_torch")

# how long a process waits for the others to join the group
JOIN_TIMEOUT = timedelta(minutes=10)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gloo process group at `tcp://{coordinator_address}`; a
    no-op for one process. Raises `ValueError` without a process id or a
    coordinator: nothing detects a cluster. Process i then takes
    `cuda:{i % device_count}` as its default card."""
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None or not coordinator_address:
        raise ValueError(
            f"a run of {num_processes} processes needs --process-id "
            "(OARFISH_PROCESS_ID) and --coordinator (OARFISH_COORDINATOR, "
            "host:port)"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"--process-id {process_id} is not in [0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        rank=int(process_id), world_size=int(num_processes),
        timeout=JOIN_TIMEOUT,
    )
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    log.info("distributed: process %d/%d (gloo, coordinator %s)",
             process_index(), process_count(), coordinator_address)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_data_mesh(device=None) -> ShardMesh:
    """The shard positions of all processes: one per process, on this
    process's device (`device`, default its card)."""
    return ShardMesh((resolve_device(device),), process_count(),
                     process_index())


def allgather_hosts(x) -> np.ndarray:
    """[P, ...] stack of a host-local value across processes (identity
    stack on one process). The host-side reduction primitive for
    sharded-input runs: per-process read counts, aux-count vectors,
    discard counters. Arrays travel pickled, bit for bit."""
    x = np.asarray(x)
    if process_count() == 1:
        return x[None]
    out = [None] * process_count()
    dist.all_gather_object(out, x)
    return np.stack(out)


def sharded_em_global_local(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    init: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype: torch.dtype = torch.float32,
    mesh: Optional[ShardMesh] = None,
    accel: str = "none",
    mult_local: Optional[np.ndarray] = None,
):
    """Data-parallel EM over distributed ingest: each process passes only
    its own reads (`--alignments x.{proc}.bam`; the global CSR is the
    disjoint union across processes). The local CSR is split over this
    process's shard positions, shard shapes are agreed globally (max over
    processes), and the same one-all-reduce-per-m-step EM runs over all
    processes. `init` must come from the global read count (callers
    aggregate with `allgather_hosts`). With `mult_local` ([B, R_local]
    replicate multiplicities over this process's reads) returns ([B, T]
    bootstrap counts, [B] iterations), the replicates one after another,
    each through the same program with a multiplicity."""
    if mesh is None:
        mesh = global_data_mesh()
    D_local = len(mesh.devices)
    sh = ShardedCsr(txp_id, weights, boundaries, num_txps, D_local)
    pads = allgather_hosts(
        np.array([sh.r_pad, sh.a_pad], dtype=np.int64)
    )
    r_pad, a_pad = (int(x) for x in pads.max(axis=0))
    if (r_pad, a_pad) != (sh.r_pad, sh.a_pad):
        sh = ShardedCsr(
            txp_id, weights, boundaries, num_txps, D_local,
            r_pad=r_pad, a_pad=a_pad,
        )
    shards = [sh.shard_data(d, dtype, dev)
              for d, dev in enumerate(mesh.devices)]
    init_t = padded_init(init, dtype, mesh.devices[0])
    if mult_local is None:
        run = make_sharded_em(mesh, num_txps, r_pad, max_iter, accel=accel,
                              dtype=dtype)
        counts, niter = run(shards, init_t, convergence_thresh)
        return counts.double().cpu().numpy()[:num_txps], int(niter)

    run_m = make_sharded_em(mesh, num_txps, r_pad, max_iter, accel=accel,
                            with_mult=True, dtype=dtype)
    mult_sh = sh.shard_multiplicity(mult_local)  # [D_local, B, r_pad]
    breps, niters = [], []
    for b in range(mult_local.shape[0]):
        mult_b = [torch.as_tensor(mult_sh[d, b], device=dev)
                  for d, dev in enumerate(mesh.devices)]
        cb, nb = run_m(shards, init_t, convergence_thresh, mult_b)
        breps.append(cb.double().cpu().numpy()[:num_txps])
        niters.append(int(nb))
    return np.stack(breps), niters


def split_bootstrap_multiplicities(
    num_boot: int, num_reads_local: int, seed: int
) -> np.ndarray:
    """[B, R_local] bootstrap multiplicities for THIS process's reads,
    jointly distributed as one global Multinomial(R_global, uniform)
    across all processes (the reference's with-replacement sample,
    `bootstrap.rs:7-16`, over the union of all shards). Uses the
    multinomial splitting property: every process draws the SAME
    process-level totals n_p ~ Multinomial(R_global, R_p/R_global) from
    the shared seed, then its own conditional Multinomial(n_p, uniform
    over its local reads) from a process-specific stream."""
    r_locals = allgather_hosts(
        np.array([num_reads_local], dtype=np.int64)
    )[:, 0]
    r_global = int(r_locals.sum())
    pidx = process_index()
    rng_shared = np.random.default_rng(seed)
    if r_global == 0:
        return np.zeros((num_boot, num_reads_local))
    per_proc = rng_shared.multinomial(
        r_global, r_locals / r_global, size=num_boot
    )  # identical on every process
    rng_local = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(pidx + 1,))
    )
    out = np.zeros((num_boot, num_reads_local))
    if num_reads_local:
        p = np.full(num_reads_local, 1.0 / num_reads_local)
        for b in range(num_boot):
            out[b] = rng_local.multinomial(int(per_proc[b, pidx]), p)
    return out


def sharded_em_global(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    init: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype: torch.dtype = torch.float32,
    mesh: Optional[ShardMesh] = None,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Data-parallel EM where every process packed the same CSR: the CSR
    is cut into one shard per global position, and each process runs the
    positions it owns (`mesh.devices`, after those of the processes
    before it); on one process this equals `sharded_em`."""
    if mesh is None:
        mesh = global_data_mesh()
    D = mesh.num_shards
    sh = ShardedCsr(txp_id, weights, boundaries, num_txps, D)
    run = make_sharded_em(mesh, num_txps, sh.r_pad, max_iter, accel=accel,
                          dtype=dtype)
    first = mesh.process_index * len(mesh.devices)
    shards = [sh.shard_data(first + i, dtype, dev)
              for i, dev in enumerate(mesh.devices)]
    counts, niter = run(shards, padded_init(init, dtype, mesh.devices[0]),
                        convergence_thresh)
    return counts.double().cpu().numpy()[:num_txps], int(niter)
