"""Read-sharded data-parallel **v4** EM over a list of torch devices.

Counterpart of the JAX package's `parallel/sharded_v4.py`. Where
`sharded_em.py` distributes the segment-sum m-step, this module distributes
the routed iteration of `ops/em_v4.py`: each shard runs the hand-written
kernels of its own routed plan (two tile permutes, two route stages, the
fused middle and the row sums per m-step), and the only exchange is the sum
of the shards' partial counts, one per m-step (`ShardMesh.reduce`).

The partials add element by element, so every shard is built inside one
**envelope** (`ops.em_v4.compute_envelope` + `merge_envelopes`: merged
bucket shapes, big-transcript rows, `t_space`) and under one route
**geometry** (`route_config` over the maxima of each chunk size's flows
across shards), as in the JAX package, whose `shard_map` needs identical
static shapes for the same reason. Shards whose data do not fill the
envelope carry dead all-zero slots, inert through every row sum and route.

There is no `shard_map` here: a `ShardedV4` holds one `EmV4Data` per shard,
each on its device, and the loop runs in the `t_space`-padded space on the
first shard's device. A batch of bootstrap replicates runs every shard's
m-step of the batch as one program where its layout allows it
(`em_v4._m_step_v4_b`), with one sum of the `[B, t_space]` partials per
iteration; the last batch is as short as it comes (no padding by
repetition). A route geometry that is not feasible raises `ValueError`:
there is no downgrade to the segment-sum sharded EM.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.em import em_loop, finish_em, squarem_em
from ..ops.em_v4 import (
    _CR_CANDIDATES,
    EmV4Data,
    _v4_finish,
    _v4_layout,
    compute_envelope,
    make_m_step,
    merge_envelopes,
    route_config,
)
from ..ops.static_permute import LANES, route_maxflow
from ..utils import trace
from .sharded_em import ShardMesh, log, log_collective, shard_devices


def _read_cuts(boundaries: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous read ranges with ~equal alignment counts per shard."""
    R = len(boundaries) - 1
    A = int(boundaries[-1])
    D = num_shards
    targets = [(A * (d + 1)) // D for d in range(D)]
    cuts = np.searchsorted(boundaries[1:], targets, side="left") + 1
    cuts = np.concatenate([[0], np.minimum(cuts, R)])
    cuts[-1] = R
    return cuts


class ShardedV4:
    """The per-shard enveloped v4 states, built on the host, shard d's on
    `devices[d]`. `datas[d]` is shard d's `EmV4Data`; every shard has the
    same `t_space` and `row_space_r`."""

    def __init__(
        self,
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        num_shards: int,
        devices: Optional[Sequence] = None,
        dtype: torch.dtype = torch.float32,
    ):
        txp_id = np.asarray(txp_id)
        weights = np.asarray(weights)
        boundaries = np.asarray(boundaries, dtype=np.int64)
        D = int(num_shards)
        devices = list(devices) if devices is not None else ["cpu"] * D
        assert len(devices) == D, (len(devices), D)
        self.num_shards = D
        self.num_txps = int(num_txps)
        self.num_reads = len(boundaries) - 1
        cuts = _read_cuts(boundaries, D)
        self.read_ranges = [
            (int(cuts[d]), int(cuts[d + 1])) for d in range(D)
        ]

        def shard_csr(d):
            s, e = self.read_ranges[d]
            lo, hi = int(boundaries[s]), int(boundaries[e])
            return (
                txp_id[lo:hi],
                weights[lo:hi],
                boundaries[s : e + 1] - lo,
            )

        with trace.span("v4.layout", shards=D) as layouts:
            env = merge_envelopes(
                [compute_envelope(shard_csr(d)[0], shard_csr(d)[2], num_txps)
                 for d in range(D)]
            )
            lays = [
                _v4_layout(*shard_csr(d), num_txps, envelope=env)
                for d in range(D)
            ]
            npads = {lay["NPAD"] for lay in lays}
            assert len(npads) == 1, f"enveloped NPADs diverged: {npads}"
            NPAD = npads.pop()
            # per-chunk-size maxflows, maxed over shards, then one shared
            # (chunk_rows, npad, (npd, Q)) route config for every shard
            mfs = {}
            for CR in _CR_CANDIDATES:
                CHR = CR * LANES
                npad_r = ((NPAD + CHR - 1) // CHR) * CHR
                mfs[CR] = max(
                    route_maxflow(
                        lay["slot_of_aln"], lay["txp_slot_of_aln"], npad_r,
                        chunk=CHR,
                    )
                    for lay in lays
                )
            self.geometry = route_config(mfs, NPAD)
        self.layout_s = layouts.seconds
        # num_reads is informational in EmV4Data; every shard carries the
        # global count, as in the JAX package
        self.datas: List[EmV4Data] = []
        for d, (lay, dev) in enumerate(zip(lays, devices)):
            with trace.span("v4.finish", shard=d):
                data = _v4_finish(lay, dtype, torch.device(dev),
                                  geometry=self.geometry)
            self.datas.append(dataclasses.replace(data,
                                                  num_reads=self.num_reads))
        for dd in self.datas[1:]:
            assert (dd.t_space, dd.row_space_r) == (
                self.datas[0].t_space, self.datas[0].row_space_r), (
                "per-shard v4 states diverged despite the envelope")
        self.row_space_r = self.datas[0].row_space_r
        self.t_space = self.datas[0].t_space
        self.read_orders = [lay["read_order"] for lay in lays]

    @classmethod
    def of_shards(cls, datas: Sequence[EmV4Data], read_ranges,
                  read_orders, geometry=None) -> "ShardedV4":
        """A sharded state from per-shard states made elsewhere (the JAX
        package's, carried across by `ops/convert.py`)."""
        self = cls.__new__(cls)
        self.datas = list(datas)
        self.num_shards = len(self.datas)
        self.num_txps = self.datas[0].num_txps
        self.num_reads = self.datas[0].num_reads
        self.read_ranges = [tuple(int(x) for x in r) for r in read_ranges]
        self.read_orders = [np.asarray(o) for o in read_orders]
        self.geometry = geometry
        self.layout_s = 0.0
        self.row_space_r = self.datas[0].row_space_r
        self.t_space = self.datas[0].t_space
        return self

    def shard_multiplicity(self, mult: np.ndarray) -> np.ndarray:
        """Map a [R] global per-read multiplicity vector to the
        [D, row_space_r] per-shard row layouts (pad rows take read 0's
        multiplicity: inert, their slots are all-zero)."""
        out = np.zeros(
            (self.num_shards, self.row_space_r), dtype=mult.dtype
        )
        for d, (s, e) in enumerate(self.read_ranges):
            out[d] = mult[s:e][self.read_orders[d]]
        return out

    def shard_multiplicity_batch(self, mult: np.ndarray) -> np.ndarray:
        """[B, R] replicate multiplicities -> [D, B, row_space_r]."""
        B = mult.shape[0]
        out = np.zeros(
            (self.num_shards, B, self.row_space_r), dtype=mult.dtype
        )
        for d, (s, e) in enumerate(self.read_ranges):
            out[d] = mult[:, s:e][:, self.read_orders[d]]
        return out


def _sharded_m_step(sh: ShardedV4, mesh: ShardMesh, mult):
    """The sum over shards of their routed m-steps, as a function of
    `prev` (`[t_space]` or `[B, t_space]`); `mult` per-shard rows
    (`[D, row_space_r]` or `[D, B, row_space_r]`, host) or None. Each
    shard's multiplicity slots are made once, here."""
    steps = [
        make_m_step(data, None if mult is None else torch.as_tensor(
            mult[d], device=data.device))
        for d, data in enumerate(sh.datas)
    ]

    def m_step(prev):
        return mesh.reduce([step(prev.to(data.device))
                            for step, data in zip(steps, sh.datas)])

    return m_step


def _ext(sh: ShardedV4, init: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(init, (0, sh.t_space - sh.num_txps))


def make_sharded_v4_runner(mesh: ShardMesh, max_iter: int,
                           min_iters: int = 50, accel: str = "none"):
    """The sharded EM as `(sh, init[T], conv, mult|None) -> (counts[T],
    niter)`: one sum of the shards' `[t_space]` partials per m-step
    (three per SQUAREM cycle; the extrapolation works on the summed
    vector, so it adds no exchange). `mult` is `[D, row_space_r]`
    (`ShardedV4.shard_multiplicity`)."""

    def run(sh: ShardedV4, init: torch.Tensor, conv: float, mult=None):
        m_step = _sharded_m_step(sh, mesh, mult)
        ext = _ext(sh, init.to(sh.datas[0].w_txp.dtype))
        if accel == "squarem":
            counts, niter = squarem_em(m_step, ext, max_iter, conv, min_iters)
        else:
            prev, niter = em_loop(m_step, ext, max_iter, conv, min_iters)
            counts = finish_em(m_step, prev)
        return counts[..., : sh.num_txps], niter

    return run


def make_sharded_v4_batch_runner(mesh: ShardMesh, max_iter: int,
                                 min_iters: int = 50, accel: str = "none"):
    """Batched bootstrap-replicate EMs over the shards: every shard runs
    all B replicates through its m-step of a batch (one launch of each
    kernel per iteration where the layout allows it), with one sum of the
    `[B, t_space]` partials per iteration and per-replicate freezing.
    `(sh, init[T], conv, mult[D, B, row_space_r]) -> (counts[B, T],
    niter[B])`."""
    single = make_sharded_v4_runner(mesh, max_iter, min_iters, accel)

    def run(sh: ShardedV4, init: torch.Tensor, conv: float, mult_b):
        B = mult_b.shape[1]
        return single(sh, init.expand(B, -1), conv, mult_b)

    return run


def sharded_v4_bootstrap(
    sh: ShardedV4,
    mesh: ShardMesh,
    init: np.ndarray,
    mult: np.ndarray,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    dtype: torch.dtype = torch.float32,
    batch: int = 8,
    accel: str = "none",
) -> Tuple[np.ndarray, np.ndarray]:
    """Run all replicates of `mult` ([n_boot, R]) through the shards in
    batches of `batch`, the last as short as it comes; returns ([n_boot,
    T] f64 counts, [n_boot] iterations)."""
    runner = make_sharded_v4_batch_runner(mesh, max_iter, accel=accel)
    init_t = torch.as_tensor(np.asarray(init, dtype=np.float64),
                             device=mesh.devices[0]).to(dtype)
    out, iters = [], []
    for b0 in range(0, mult.shape[0], batch):
        mb = sh.shard_multiplicity_batch(mult[b0 : b0 + batch])
        cb, nb = runner(sh, init_t, convergence_thresh, mb)
        out.append(cb.double().cpu().numpy())
        iters.append(nb.cpu().numpy())
    return np.concatenate(out), np.concatenate(iters)


def build_sharded_v4(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    devices=None,
    num_shards: int = 0,
    dtype: torch.dtype = torch.float32,
) -> Tuple[ShardedV4, ShardMesh]:
    """Envelope-build the per-shard v4 states and their mesh (the
    expensive host step, reusable across the point EM and bootstrap
    batches). `devices` lists the devices shard d is placed on
    (`devices[d % len(devices)]`; default every visible card);
    `num_shards=0` takes one shard per device."""
    if devices is None:
        devices = shard_devices(None, num_shards)
    D = num_shards or len(devices)
    mesh = ShardMesh.local([devices[d % len(devices)] for d in range(D)])
    sh = ShardedV4(txp_id, weights, boundaries, num_txps, D,
                   devices=mesh.devices, dtype=dtype)
    log_collective("sharded v4", sh.t_space, 1, dtype, mesh)
    return sh, mesh


def sharded_v4_em(
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
    multiplicity: Optional[np.ndarray] = None,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Host entry: envelope-build the shards, run the sharded EM, return
    (counts[T] f64, niter). Raises ValueError where the v4 routing is
    degenerate."""
    sh, mesh = build_sharded_v4(
        txp_id, weights, boundaries, num_txps,
        devices=devices, num_shards=num_shards, dtype=dtype,
    )
    run = make_sharded_v4_runner(mesh, max_iter, accel=accel)
    mult = None if multiplicity is None else sh.shard_multiplicity(
        np.asarray(multiplicity, dtype=np.float64))
    init_t = torch.as_tensor(np.asarray(init, dtype=np.float64),
                             device=mesh.devices[0]).to(dtype)
    counts, niter = run(sh, init_t, convergence_thresh, mult)
    log.info("sharded v4 EM (%d shards) converged after %d iterations",
             sh.num_shards, int(niter))
    return counts.double().cpu().numpy(), int(niter)
