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
here and in the JAX package. The CLI's one-device path draws on a thread
of its own (`DrawStream`), a batch at a time from the seed's one stream,
while the route, the point EM and the earlier batches run.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

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


class DrawStream:
    """The rows of `sample_multiplicities(rng, num_boot, num_reads)[:,
    order]`, drawn on a thread of its own (`boot-draw`) `batch`
    replicates a call from the same stream: a generator's consecutive
    `multinomial` calls give the rows of one call, and each call releases
    the interpreter lock. The thread draws from its start; `set_order`
    gives the layout's read order (None: the rows as drawn), and the
    batches drawn before it wait for it. The rows are int32 (a
    multiplicity is a small count, so a device `.to(dtype)` gives the
    float array's values); pad rows of an order take read 0's count, as
    the fancy index does.

    It is indexed like the `[num_boot, rows]` array it fills: an index or
    a slice blocks until its replicates' batches are written, and a wait
    is counted (`boot.draw_wait_s`, its seconds, and `boot.draws_waited`,
    `utils/trace.py`). The draw is the span `boot.draw` on the thread. An
    exception there is raised at the next access; `close()` stops the
    thread between batches and joins it."""

    def __init__(self, rng: np.random.Generator, num_boot: int,
                 num_reads: int, batch: int = BOOT_BATCH):
        self.num_boot, self.num_reads, self.batch = num_boot, num_reads, batch
        self._rng = rng
        self._order: Optional[np.ndarray] = None
        self._ordered = threading.Event()
        self._ready = [threading.Event() for _ in range(0, num_boot, batch)]
        self._rows: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._draw, name="boot-draw",
                                        daemon=True)
        self._thread.start()

    def set_order(self, order: Optional[np.ndarray]) -> None:
        self._order = order
        self._ordered.set()

    def close(self) -> None:
        self._stop = True
        self._ordered.set()
        self._thread.join()

    def __len__(self) -> int:
        return self.num_boot

    def __getitem__(self, key):
        picked = range(self.num_boot)[key]
        if isinstance(picked, int):
            picked = range(picked, picked + 1)
        if picked:
            ready = self._ready[min(picked) // self.batch:
                                max(picked) // self.batch + 1]
            if not all(e.is_set() for e in ready):
                t0 = time.perf_counter()
                for e in ready:
                    e.wait()
                trace.count("boot.draw_wait_s", time.perf_counter() - t0)
                trace.count("boot.draws_waited")
        if self._error is not None:
            raise self._error
        return self._rows[key]

    def _draw(self) -> None:
        done = False
        try:
            with trace.span("boot.draw", replicates=self.num_boot,
                            reads=self.num_reads):
                p = np.full(self.num_reads, 1.0 / self.num_reads)
                drawn: List[Tuple[int, np.ndarray]] = []
                for b0 in range(0, self.num_boot, self.batch):
                    if self._stop:
                        break
                    n = min(self.batch, self.num_boot - b0)
                    counts = self._rng.multinomial(self.num_reads, p, size=n)
                    drawn.append((b0, counts.astype(np.int32)))
                    if self._ordered.is_set():
                        self._place(drawn)
                        drawn = []
                self._ordered.wait()
                if not self._stop:
                    self._place(drawn)
                    done = True
        except Exception as e:  # raised again to the consumer
            self._error = e
        finally:
            if not done and self._error is None:
                self._error = RuntimeError("the bootstrap draw was closed")
            for e in self._ready:
                e.set()

    def _place(self, drawn: List[Tuple[int, np.ndarray]]) -> None:
        order = self._order
        for b0, counts in drawn:
            if self._rows is None:
                width = self.num_reads if order is None else len(order)
                self._rows = np.empty((self.num_boot, width), np.int32)
            out = self._rows[b0:b0 + len(counts)]
            if order is None:
                out[...] = counts
            else:
                np.take(counts, order, axis=1, out=out)
            self._ready[b0 // self.batch].set()


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
    mult,
    init: torch.Tensor,
    batch: int = BOOT_BATCH,
) -> Tuple[np.ndarray, np.ndarray]:
    """Feed `mult` ([B, R] on the host: an array, or a `DrawStream` whose
    batches are taken as they are written) to `run(init[b, T], mult[b, R]) ->
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
    its m-steps, summed), the kernels' `launches`, and of a stream's
    rows `draw_wait_s` (the seconds the batches waited for them, summed)
    and `draws_waited` (the batches that waited)."""
    with trace.span("boot.batches", {"launches": trace.launches,
                                     "draw_wait_s": "boot.draw_wait_s",
                                     "draws_waited": "boot.draws_waited"}
                    ) as sp:
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
