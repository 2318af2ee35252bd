"""Bootstrap inferential replicates, batched along a leading axis.

Counterpart of the JAX package's `ops/bootstrap.py`. The reference samples `n`
read indices uniformly with replacement per replicate and reruns the
serial EM over that multiset (`bootstrap.rs:7-16`, `em.rs:273-314`).
Because the M step is linear in read occurrences, a with-replacement
index sample is exactly a per-read multiplicity vector
`c ~ Multinomial(R, 1/R)`; the device EM takes that vector directly and
runs the replicates on a pool of slots (`run_replicates`), each replicate
frozen at its own convergence point (see `em.em_loop`) and its slot
handed to the next one. What a batched step costs is the formulation's
business: the routed v4 EM runs it as one program
(`em_v4._m_step_v4_batch`).

The draw stays in NumPy so that one `--seed` gives the same replicates
here and in the JAX package. The CLI's one-device path draws on a thread
of its own (`DrawStream`), a batch at a time from the seed's one stream,
while the route, the point EM and the earlier batches run.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from .em import (
    CYCLES,
    MIN_ITERS,
    BatchStep,
    EmData,
    final_input,
    hold_frozen,
    initial_abundances,
    replicate_step,
)

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


def _recorded(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded on `device`'s current stream; None on the CPU,
    whose work is done when it returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def run_replicates(
    run: BatchStep,
    mult,
    init: torch.Tensor,
    batch: int = BOOT_BATCH,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the replicates of `mult` ([N, R] on the host: an array, or a
    `DrawStream` whose rows are taken as they are written) from `init`
    ([T]) through `run`'s batched m-step on a pool of `batch` slots;
    returns ([N, T] f64 counts, [N] iterations) in replicate order.

    Every slot holds one replicate: a row of the `[B, S]` state, its
    iteration count and a row of the multiplicities. Each step is one
    cycle of `run.m_step` over the occupied slots. A replicate freezes
    where its own run would stop (`em.em_loop` and `em.squarem_loop`:
    converged after `MIN_ITERS`, or out of `max_iter`), holds its state,
    and its next step is `em.finish_em`'s final step, in the same launch
    as the others' cycles. The host learns of a freeze a step late, from
    flags copied behind the next step, so it never waits for the device
    while the device has nothing queued. It then writes the slot's final
    step to the replicate's row of the output and loads the next
    replicate into the slot; once none is left, finished slots leave the
    batch. Neither when a replicate runs nor beside which others changes
    its values, so the batch size does not change what it computes (on
    the card the order of a formulation's batched sums could, and with it
    the last bits). The rows of `mult` are taken `batch` at a time, when
    the first of them is needed.

    The pool is the span `boot.batches` (`utils/trace.py`), which ends
    after the last copy to the host. Its attributes, in m-steps (a
    SQUAREM cycle is 3): `msteps` (the batch's steps), `slot_steps` (each
    step's size, summed), `useful_steps` (each replicate's iterations
    and its final step, summed), `tail_steps` (steps with fewer than
    `batch` slots occupied), `refills` (replicates loaded into a slot
    that another one had left), `batches` (the `batch` rows of `mult`
    taken at a time), `batch`, the kernels' `launches`, and of a
    stream's rows `draw_wait_s` (the seconds spent waiting for them) and
    `draws_waited` (the takes that waited)."""
    cycle, k = CYCLES[run.accel]
    n, T, device = len(mult), init.shape[-1], init.device
    # pageable: a pinned [N, T] block would stay in the host allocator's
    # cache from job to job, beside the writers' copy of the last one
    counts = torch.empty((n, T), dtype=torch.float64)
    iters = np.zeros(n, dtype=np.int32)
    finished = np.zeros(n, dtype=bool)
    start_frozen = k > run.max_iter

    def take(first):
        rows = torch.as_tensor(mult[first:first + batch], device=device)
        return run.mult(rows.to(init.dtype))

    def may_freeze(age):
        return age * k > MIN_ITERS or (age + 1) * k > run.max_iter

    with trace.span("boot.batches", {"launches": trace.launches,
                                     "draw_wait_s": "boot.draw_wait_s",
                                     "draws_waited": "boot.draws_waited"}
                    ) as sp:
        slots = list(range(min(batch, n)))  # the replicate in each slot
        ages = [0] * len(slots)  # the cycles each has run
        loaded = len(slots)
        taken = first_taken = 0
        if slots:
            taken, chunk = 1, take(0)
            mult_b = chunk[:len(slots)].clone()
        ext = run.start(init)
        prev = ext.expand(len(slots), -1).clone()
        niter = torch.zeros(len(slots), dtype=torch.int32, device=device)
        frozen = torch.full((len(slots),), start_frozen, device=device)
        known = {}  # replicate -> iterations, once its flag has been read
        last = in_flight = None
        msteps = slot_steps = tail_steps = refills = 0
        while slots:
            if known:
                keep = []
                for j, r in enumerate(slots):
                    if r not in known:
                        keep.append(j)
                        continue
                    # the step after the freeze was the final one (the
                    # copy waits for it, at most a step)
                    counts[r].copy_(last[j, :T].double())
                    iters[r], finished[r] = known.pop(r), True
                    if loaded == n:
                        continue
                    if loaded == first_taken + batch:
                        first_taken, chunk = loaded, take(loaded)
                        taken += 1
                    mult_b[j].copy_(chunk[loaded - first_taken])
                    prev[j].copy_(ext)
                    niter[j] = 0
                    frozen[j] = start_frozen
                    slots[j], ages[j] = loaded, 0
                    loaded += 1
                    refills += 1
                    keep.append(j)
                if not keep:
                    break
                if len(keep) < len(slots):
                    idx = torch.tensor(keep, device=device)
                    prev, niter, frozen, mult_b = (
                        t.index_select(0, idx)
                        for t in (prev, niter, frozen, mult_b))
                    slots = [slots[j] for j in keep]
                    ages = [ages[j] for j in keep]
            B = len(slots)
            # a frozen slot's step is the final one
            last, curr, newly, stepped = cycle(
                lambda p: run.m_step(p, mult_b), final_input(prev, frozen),
                niter, run.convergence_thresh, MIN_ITERS)
            prev, niter, frozen = hold_frozen(frozen, prev, niter, curr,
                                              stepped, newly)
            frozen = frozen | (niter + k > run.max_iter)
            ages = [a + 1 for a in ages]
            msteps += k
            slot_steps += k * B
            tail_steps += k if B < batch else 0
            # this step's flags start for the host, the last step's are
            # read: no flag while no slot can have frozen
            sent = None
            if any(map(may_freeze, ages)):
                flags = _to_host(torch.stack((niter, frozen.to(niter.dtype))))
                sent = (list(slots), flags, _recorded(device))
            if in_flight is not None:
                rows, flags, event = in_flight
                if event is not None:
                    event.synchronize()
                for r, it, fr in zip(rows, *flags.tolist()):
                    if fr and not finished[r]:
                        known[r] = it
            in_flight = sent
        if init.is_cuda:
            torch.cuda.synchronize(device)
        sp.set(batches=taken, batch=batch, msteps=msteps,
               useful_steps=int(iters.sum()) + n, slot_steps=slot_steps,
               tail_steps=tail_steps, refills=refills)
    return counts.numpy(), iters


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
    step = replicate_step(data, max_iter, convergence_thresh, accel=accel)
    return run_replicates(step, mult, init)[0]
