"""Read-sharded data-parallel EM over a list of torch devices.

Counterpart of the JAX package's `parallel/sharded_em.py`. The reference is
single-process shared-memory (no collectives of any kind); distribution is
new design. Reads (CSR rows) are cut into contiguous shards of about equal
alignment counts; every m-step each shard computes partial per-transcript
counts from its reads, and the partials are added into one vector that
every shard takes as the next iterate, so the convergence decision is the
same everywhere.

Where the JAX package runs the loop inside one `shard_map` with a `psum`,
the "mesh" here is an explicit `ShardMesh`: the devices of this process's
shards (shard d on `devices[d % len(devices)]`; on one card every shard
lives there and they run one after another) and, across processes, a
`torch.distributed` group. The partials are added in shard order on the
first shard's device, then all-reduced across processes: one all-reduce
per m-step (three per SQUAREM cycle), of `T + 1` values. Every rank
receives the same bits. The loop is `ops/em.py`'s.

Unlike the JAX package's `sharded_em`, which stacks `num_shards` shards onto
`devices[:num_shards]` and so quantifies only shard 0's reads when there are
more shards than devices, any number of shards gives the unsharded counts.

Bootstrap replicates ride the same program through a per-read multiplicity
vector (`with_mult`): replicates are shard-local; only the partial counts
cross between processes.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.em import EmData, _m_step, csr_offsets, em_loop, finish_em, squarem_em
from ..utils import trace

log = logging.getLogger("oarfish_tpu_torch")


def shard_devices(device, num_shards: int) -> list:
    """The devices of `num_shards` shards in one process: shard d on the
    d % n-th visible card for a CUDA `device` (all of them on the CPU for
    `cpu`), so a count above the number of cards places several shards on
    one card. `num_shards=0` takes one shard per visible card."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(num_shards, 1)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[d % len(cards)] for d in range(num_shards or len(cards))]


@dataclass(frozen=True)
class ShardMesh:
    """The shards this process runs and the processes that share the run.

    `devices[i]` holds local shard i; with `num_processes > 1` process p owns
    global shard positions `p * len(devices) ...` and the default
    `torch.distributed` group joins them."""

    devices: Tuple[torch.device, ...]
    num_processes: int = 1
    process_index: int = 0

    @staticmethod
    def local(devices: Sequence) -> "ShardMesh":
        return ShardMesh(tuple(torch.device(d) for d in devices))

    @property
    def num_shards(self) -> int:
        return len(self.devices) * self.num_processes

    def reduce(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the local shards' partials, added in shard order on
        the first shard's device, then across processes: every process and
        every shard gets the same bits. Gloo adds across processes on the
        host, so a CUDA sum goes there and back. The counters
        `allreduce.calls` and `allreduce.seconds` (`utils/trace.py`) count
        the all-reduces and the seconds from the partial's arrival on the
        host to the sum's, waiting for the slowest process included."""
        total = partials[0]
        for p in partials[1:]:
            total = total + p.to(total.device)
        if self.num_processes > 1:
            host = total.cpu()
            t0 = time.perf_counter()
            dist.all_reduce(host)
            trace.count("allreduce.seconds", time.perf_counter() - t0)
            trace.count("allreduce.calls")
            total = host.to(total.device)
        return total


def log_collective(what: str, n: int, per: int, dtype: torch.dtype,
                   mesh: ShardMesh) -> None:
    """The one cross-shard exchange of the run: its size and how often."""
    log.info(
        "%s collective: sum of %d %s values (%.2f MB) x %d per %s over "
        "%d shards in %d process(es)%s",
        what, n, str(dtype).replace("torch.", ""),
        n * torch.empty(0, dtype=dtype).element_size() / 1e6, per,
        "SQUAREM cycle" if per == 3 else "EM iteration", mesh.num_shards,
        mesh.num_processes,
        ", all-reduced through gloo" if mesh.num_processes > 1 else "",
    )


class ShardedCsr:
    """Host-side CSR partitioner: contiguous read ranges with ~equal
    alignment counts per shard, padded to a common (A_pad, R_pad)."""

    def __init__(
        self,
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        num_shards: int,
        r_pad: int = 0,
        a_pad: int = 0,
    ):
        """`r_pad`/`a_pad` force the padded shard shape (multi-process
        runs agree on the max across processes)."""
        R = len(boundaries) - 1
        A = len(txp_id)
        D = num_shards
        self.num_txps = int(num_txps)
        self.num_shards = D
        self.num_reads = R
        # split reads so each shard holds a contiguous range with roughly
        # equal alignments (balanced memory and work per device)
        targets = [(A * (d + 1)) // D for d in range(D)]
        cuts = np.searchsorted(boundaries[1:], targets, side="left") + 1
        cuts = np.concatenate([[0], np.minimum(cuts, R)])
        cuts[-1] = R
        self.read_ranges = [
            (int(cuts[d]), int(cuts[d + 1])) for d in range(D)
        ]
        r_need = max(1, max(e - s for s, e in self.read_ranges))
        a_need = max(
            1,
            max(
                int(boundaries[e] - boundaries[s])
                for s, e in self.read_ranges
            ),
        )
        assert not r_pad or r_pad >= r_need, (r_pad, r_need)
        assert not a_pad or a_pad >= a_need, (a_pad, a_need)
        r_pad = r_pad or r_need
        a_pad = a_pad or a_need
        Tslot = self.num_txps  # dummy transcript slot index
        self.r_pad, self.a_pad = r_pad, a_pad

        txp = np.full((D, a_pad), Tslot, dtype=np.int32)
        wts = np.zeros((D, a_pad), dtype=np.float64)
        rid = np.full((D, a_pad), r_pad, dtype=np.int32)
        perm = np.zeros((D, a_pad), dtype=np.int32)
        tsrt = np.full((D, a_pad), Tslot, dtype=np.int32)
        nreads = np.zeros((D,), dtype=np.int32)
        for d, (s, e) in enumerate(self.read_ranges):
            lo, hi = int(boundaries[s]), int(boundaries[e])
            a = hi - lo
            txp[d, :a] = txp_id[lo:hi]
            wts[d, :a] = weights[lo:hi]
            lens = np.diff(boundaries[s : e + 1])
            rid[d, :a] = np.repeat(
                np.arange(e - s, dtype=np.int32), lens
            )
            p = np.argsort(txp[d], kind="stable").astype(np.int32)
            perm[d] = p
            tsrt[d] = txp[d][p]
            nreads[d] = e - s
        self.txp_id = txp
        self.weights = wts
        self.read_id = rid
        self.txp_sort_perm = perm
        self.txp_id_sorted = tsrt
        self.shard_num_reads = nreads

    def shard_multiplicity(self, mult: np.ndarray) -> np.ndarray:
        """Shard a [B, R] replicate-multiplicity matrix to
        [D, B, r_pad] aligned with the read ranges."""
        B = mult.shape[0]
        out = np.zeros((self.num_shards, B, self.r_pad), dtype=mult.dtype)
        for d, (s, e) in enumerate(self.read_ranges):
            out[d, :, : e - s] = mult[:, s:e]
        return out

    def shard_data(self, d: int, dtype: torch.dtype, device) -> EmData:
        """Shard d as the segment-sum EM's device state: `r_pad + 1` reads
        (the last the pads' dummy read) and `T + 1` transcripts (the last
        the pads' dummy slot)."""
        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=device)

        return EmData(
            txp_id=i32(self.txp_id[d]),
            weights=torch.as_tensor(self.weights[d], device=device).to(dtype),
            read_id=i32(self.read_id[d]),
            txp_sort_perm=i32(self.txp_sort_perm[d]),
            txp_id_sorted=i32(self.txp_id_sorted[d]),
            read_offsets=torch.as_tensor(
                csr_offsets(self.read_id[d], self.r_pad + 1), device=device),
            txp_offsets=torch.as_tensor(
                csr_offsets(self.txp_id_sorted[d], self.num_txps + 1),
                device=device),
            num_reads=self.r_pad + 1,
            num_txps=self.num_txps + 1,
        )


def make_sharded_em(
    mesh: ShardMesh,
    num_txps: int,
    r_pad: int,
    max_iter: int,
    min_iters: int = 50,
    accel: str = "none",
    with_mult: bool = False,
    dtype: torch.dtype = torch.float32,
):
    """The sharded EM as a function `(shards, init, conv[, mult]) ->
    (counts, niter)`: `shards` the local shards' `EmData`
    (`ShardedCsr.shard_data`, one per `mesh.devices`), `init` `[T + 1]`
    on the first shard's device (the last entry the dummy slot, 0). With
    `with_mult` a trailing list of per-shard `[r_pad]` multiplicities
    (bootstrap replicates over sharded reads). Returns `[T + 1]` counts
    on the first shard's device and the iteration count."""
    # the only cross-shard traffic: the partial counts of every m-step
    log_collective("sharded EM", num_txps + 1, 3 if accel == "squarem" else 1,
                   dtype, mesh)

    def run(shards: Sequence[EmData], init: torch.Tensor, conv: float,
            mult: Optional[Sequence[torch.Tensor]] = None):
        assert len(shards) == len(mesh.devices)
        assert (mult is not None) == with_mult
        nums = [None] * len(shards)
        if mult is not None:
            # the dummy read takes multiplicity 0
            nums = [torch.nn.functional.pad(m.to(init.dtype), (0, 1))
                    for m in mult]

        def m_step(prev):
            return mesh.reduce([
                _m_step(data, prev.to(data.device), num)
                for data, num in zip(shards, nums)
            ])

        if accel == "squarem":
            return squarem_em(m_step, init, max_iter, conv, min_iters)
        prev, niter = em_loop(m_step, init, max_iter, conv, min_iters)
        return finish_em(m_step, prev), niter

    return run


def sharded_em(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    init: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype: torch.dtype = torch.float32,
    devices=None,
    num_shards: int = 0,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Host entry: shard the CSR, run the sharded EM, return (counts[T],
    niter). `devices` lists the devices shard d is placed on
    (`devices[d % len(devices)]`; default every visible card);
    `num_shards=0` takes one shard per device."""
    if devices is None:
        devices = shard_devices(None, num_shards)
    D = num_shards or len(devices)
    mesh = ShardMesh.local([devices[d % len(devices)] for d in range(D)])
    sh = ShardedCsr(txp_id, weights, boundaries, num_txps, D)
    run = make_sharded_em(mesh, num_txps, sh.r_pad, max_iter, accel=accel,
                          dtype=dtype)
    shards = [sh.shard_data(d, dtype, dev)
              for d, dev in enumerate(mesh.devices)]
    counts, niter = run(shards, padded_init(init, dtype, mesh.devices[0]),
                        convergence_thresh)
    return counts.double().cpu().numpy()[:num_txps], int(niter)


def padded_init(init: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """`init` `[T]` with the dummy slot's 0 appended, on `device`."""
    t = torch.as_tensor(np.asarray(init, dtype=np.float64), device=device)
    return torch.nn.functional.pad(t.to(dtype), (0, 1))
