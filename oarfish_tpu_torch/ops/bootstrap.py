"""Bootstrap inferential replicates, batched along a leading axis.

Counterpart of the JAX package's `ops/bootstrap.py`. The reference samples `n`
read indices uniformly with replacement per replicate and reruns the
serial EM over that multiset (`bootstrap.rs:7-16`, `em.rs:273-314`).
Because the M step is linear in read occurrences, a with-replacement
index sample is exactly a per-read multiplicity vector
`c ~ Multinomial(R, 1/R)`; the device EM takes that vector directly and
runs a batch of replicates as one loop, each replicate frozen at its own
convergence point (see `em.em_loop`). What a batch costs is the
formulation's business: the routed v4 EM runs it as one program
(`em_v4._m_step_v4_batch`).

The draw stays in NumPy so that one `--seed` gives the same replicates
here and in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from .em import EmData, initial_abundances, run_em, run_em_squarem

# replicates per batched loop: bounds the [B, A] temporaries of an m-step
BOOT_BATCH = 8


def sample_multiplicities(
    rng: np.random.Generator, num_boot: int, num_reads: int
) -> np.ndarray:
    """[B, R] multinomial read multiplicities (≡ sorted with-replacement
    index samples of size R)."""
    return rng.multinomial(
        num_reads, np.full(num_reads, 1.0 / num_reads), size=num_boot
    ).astype(np.float64)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start the copy of a device tensor into pinned host memory and return
    the host tensor; it holds the values once the device has been
    synchronized. A CPU tensor is returned as it is."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def run_replicates(
    run: Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]],
    mult: np.ndarray,
    init: torch.Tensor,
    batch: int = BOOT_BATCH,
) -> Tuple[np.ndarray, np.ndarray]:
    """Feed `mult` ([B, R], host) to `run(init[b, T], mult[b, R]) ->
    (counts[b, T], niter[b])` in batches of at most `batch` replicates;
    returns ([B, T] f64 counts, [B] iterations) on the host. Freezing is
    per replicate, so the batch size does not change what a replicate
    computes (on the card the order of a formulation's batched sums may
    depend on it, and with it the last bits); a batch takes as many m-steps
    as its slowest replicate. The
    last batch is as short as it comes. Each batch's results stay on the
    device until the copy into pinned host memory that is started behind
    them, and are read only after the last batch has been run.

    The batches are the span `boot.batches` (`utils/trace.py`), which ends
    after the synchronization. Its attributes: `batches`, `batch`,
    `useful_steps` (the m-steps each replicate ran until it froze, the
    final step included, summed), `slot_steps` (each batch's size times
    its m-steps, summed) and the kernels' `launches`."""
    with trace.span("boot.batches", {"launches": trace.launches}) as sp:
        pending = []
        for b0 in range(0, len(mult), batch):
            m = torch.as_tensor(mult[b0:b0 + batch],
                                device=init.device).to(init.dtype)
            counts_b, niter_b = run(init.expand(m.shape[0], -1), m)
            pending.append((_to_host(counts_b.double()), _to_host(niter_b)))
        if init.is_cuda:
            torch.cuda.synchronize(init.device)
        counts = np.concatenate([c.numpy() for c, _ in pending], axis=0)
        iters = [n.numpy() for _, n in pending]
        # a batch runs as many m-steps as its slowest replicate, and one
        # final step
        sp.set(batches=len(pending), batch=batch,
               useful_steps=int(sum(n.sum() + len(n) for n in iters)),
               slot_steps=int(sum(len(n) * (n.max() + 1) for n in iters)))
    return counts, np.concatenate(iters, axis=0)


def bootstrap(
    data: EmData,
    num_boot: int,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    init_abundances: Optional[np.ndarray] = None,
    seed: int = 0,
    accel: str = "none",
) -> np.ndarray:
    """Run `num_boot` replicates; returns [B, T] f64 counts."""
    rng = np.random.default_rng(seed)
    mult = sample_multiplicities(rng, num_boot, data.num_reads)
    # per-replicate total weight: the multiset size is exactly R
    init = initial_abundances(data, init_abundances, data.weights.dtype)
    run_one = run_em_squarem if accel == "squarem" else run_em
    return run_replicates(
        lambda i, m: run_one(
            data, i, max_iter, convergence_thresh, multiplicity=m
        ),
        mult, init,
    )[0]
