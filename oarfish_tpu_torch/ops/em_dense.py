"""Dense one-hot EM for batches of tiny problems (single-cell buckets).

Counterpart of the JAX package's `ops/em_dense.py`. A cell's EM is small
(after power-of-two bucketing at most a few thousand alignment slots, a
few hundred local transcripts), so a bucket of cells runs as batched
products with two 0/1 incidence matrices per cell, built on the device by
comparing the packed per-slot indices against `arange` (the host ships
indices and weights, not matrices):

    S [a_pad, t_pad]  alignment -> local transcript (one-hot rows)
    R [r_pad, a_pad]  read -> alignment (contiguous-segment rows)

and the fused E/M step (`em.rs:87-133`) is four batched products:

    contrib = (S @ prev) * w          denom = R @ contrib
    inc     = contrib * (R^T @ scale) curr  = S^T @ inc

Pad rows are all-zero: pad alignments contribute nothing, pad reads get
denominator 0 and scale 0, pad transcripts stay 0.

The JAX package runs these as XLA dots at `Precision.HIGHEST`, outside any
Pallas kernel; here they are `torch.bmm`, in full f32 on the card (TF32 is
off, `device.py`). The matrices are kept in the compute dtype (0/1 is
exact) rather than bf16 widened every step. The loops are the port's
`em.em_loop` / `em.squarem_em` with the cell axis leading, so each cell
freezes at its own stopping point (the `run_em` protocol: min 50
iterations, zero below 1e-5, one final step). `run_em_dense_scan` runs a
bucket as sub-batches one after another, the counterpart of the JAX
package's `lax.scan` over sub-batches: only one sub-batch's matrices are
alive at a time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..constants import EM_DENOM_THRESH
from ..device import resolve_device
from .em import em_loop, finish_em, squarem_em


@dataclass(frozen=True)
class DenseCellEm:
    """One bucket of cells, packed: per-alignment-slot local transcript and
    read indices (-1 on pad slots) and weights, on the run's device."""

    txp: torch.Tensor  # [B, a_pad] i16 (or i32) local transcript per slot
    rid: torch.Tensor  # [B, a_pad] i16 (or i32) read index per slot
    weights: torch.Tensor  # [B, a_pad] compute dtype (0 on pad slots)
    t_pad: int
    r_pad: int

    @staticmethod
    def build(
        txp_local: List[np.ndarray],
        weights: List[np.ndarray],
        read_id: List[np.ndarray],
        a_pad: int,
        r_pad: int,
        t_pad: int,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "DenseCellEm":
        """`device=None` is the package default (`cuda`; raises without a
        card), `"cpu"` is the host on request."""
        device = resolve_device(device)
        B = len(txp_local)
        # i16 slot indices where the padded spaces fit (-1 pads fit too)
        idt = (np.int16 if t_pad <= 32767 and r_pad <= 32767
               else np.int32)
        TX = np.full((B, a_pad), -1, dtype=idt)
        RD = np.full((B, a_pad), -1, dtype=idt)
        W = np.zeros((B, a_pad), dtype=np.float64)
        for i in range(B):
            a = len(txp_local[i])
            TX[i, :a] = txp_local[i]
            RD[i, :a] = read_id[i]
            W[i, :a] = weights[i]
        return DenseCellEm(
            txp=torch.as_tensor(TX, device=device),
            rid=torch.as_tensor(RD, device=device),
            weights=torch.as_tensor(W, device=device).to(dtype),
            t_pad=t_pad, r_pad=r_pad,
        )

    def cells(self, lo: int, hi: int) -> "DenseCellEm":
        """Cells `lo` to `hi - 1` (views)."""
        return DenseCellEm(self.txp[lo:hi], self.rid[lo:hi],
                           self.weights[lo:hi], self.t_pad, self.r_pad)

    def densify(self) -> "DenseSR":
        """One-hot S `[B, a_pad, t_pad]` and R `[B, r_pad, a_pad]` in the
        weights' dtype. Pad slots (-1) match no index, so pad rows and
        columns are all-zero."""
        dev, dt = self.weights.device, self.weights.dtype
        iota_t = torch.arange(self.t_pad, dtype=torch.int32, device=dev)
        iota_r = torch.arange(self.r_pad, dtype=torch.int32, device=dev)
        txp = self.txp.to(torch.int32)
        rid = self.rid.to(torch.int32)
        S = (txp[:, :, None] == iota_t[None, None, :]).to(dt)
        R = (rid[:, None, :] == iota_r[None, :, None]).to(dt)
        return DenseSR(S=S, R=R, weights=self.weights)


@dataclass(frozen=True)
class DenseSR:
    """Densified incidence matrices, made once per EM run."""

    S: torch.Tensor  # [B, a_pad, t_pad] 0/1: alignment -> transcript
    R: torch.Tensor  # [B, r_pad, a_pad] 0/1: read -> alignment
    weights: torch.Tensor  # [B, a_pad] (0 on pad slots)


def _bmv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product `[B, n, k] @ [B, k] -> [B, n]`."""
    return torch.bmm(m, v.unsqueeze(-1)).squeeze(-1)


def _m_step_dense(data: DenseSR, prev_b: torch.Tensor) -> torch.Tensor:
    """One fused E/M step over the batch of cells: four batched products
    over the incidence matrices, densified once outside the loop."""
    dt = prev_b.dtype
    S, R = data.S.to(dt), data.R.to(dt)
    contrib = _bmv(S, prev_b) * data.weights.to(dt)
    denom = _bmv(R, contrib)
    scale = torch.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
    inc = contrib * _bmv(R.transpose(1, 2), scale)
    return _bmv(S.transpose(1, 2), inc)


def run_em_dense(
    data: DenseCellEm,
    init_b: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched EM loop with per-cell freezing, the `run_em` protocol
    (`em.rs:144-255`) over the cell axis. Returns (`[B, t_pad]` counts,
    `[B]` iteration counts)."""
    sr = data.densify()

    def m_step(p):
        return _m_step_dense(sr, p)

    prev, niter = em_loop(m_step, init_b, max_iter, convergence_thresh,
                          min_iters)
    return finish_em(m_step, prev), niter


def run_em_dense_squarem(
    data: DenseCellEm,
    init_b: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SQUAREM-accelerated variant (the protocol of `run_em_squarem`)."""
    sr = data.densify()
    return squarem_em(lambda p: _m_step_dense(sr, p), init_b, max_iter,
                      convergence_thresh, min_iters)


def run_em_dense_scan(
    data: DenseCellEm,
    init_b: torch.Tensor,
    sub: int,
    max_iter: int,
    convergence_thresh: float,
    min_iters: int = 50,
    accel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A whole bucket as sub-batches of `sub` cells, one after another (the
    last may be shorter): only one sub-batch's S and R exist at a time.
    Returns (`[B, t_pad]` counts, `[B]` iterations) on the device."""
    run = run_em_dense_squarem if accel else run_em_dense
    B = init_b.shape[0]
    counts = init_b.new_empty((B, data.t_pad))
    niter = torch.empty(B, dtype=torch.int32, device=init_b.device)
    for lo in range(0, B, sub):
        hi = min(lo + sub, B)
        counts[lo:hi], niter[lo:hi] = run(
            data.cells(lo, hi), init_b[lo:hi], max_iter,
            convergence_thresh, min_iters)
    return counts, niter
