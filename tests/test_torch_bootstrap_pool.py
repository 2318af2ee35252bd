"""`ops/bootstrap.py::run_replicates`: bootstrap replicates on a pool of
slots, a slot whose replicate has frozen taking the next one.

On a CSR whose replicates stop after 52 to 120 iterations (one held to
`max_iter` = 120), for the routed v4 EM (its kernels' plain versions,
f32), the scatter-free EM (`fast`, f32) and the segment-sum EM (f64):
every replicate's counts and iterations out of the pool are those of its
run alone through the formulation's `run_em*`, bit for bit, for pools of
1, 3 and 8 slots and 1 to 100 replicates, the multiplicities an array or
a `DrawStream` (a slow one too). v3 (f32, its plain versions), which has
no batch arm and which the CLI runs on one slot, on a CSR of its own
(v3's permutes degenerate below a few thousand reads) whose replicates
stop after 62 and `max_iter` = 64 iterations: one slot, two replicates.
The span `boot.batches` counts the
schedule that list scheduling gives: each replicate holds its slot for
its iterations and its final step and no more, then the next one takes
the first slot freed.
"""

import heapq
import logging

import numpy as np
import pytest
import torch

from oarfish_tpu_torch.ops import bootstrap as boot
from oarfish_tpu_torch.ops import em as tem
from oarfish_tpu_torch.ops import em_fast as tfast
from oarfish_tpu_torch.ops import em_v3 as tv3
from oarfish_tpu_torch.ops import em_v4 as tv4
from test_torch_bootstrap_stream import SlowRng, batches_attrs
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

LOGGER = "oarfish_tpu_torch"
MAX_ITER, THRESH = 120, 1e-3
MULT_SEED = 5  # replicate 2 runs into MAX_ITER
N_MAX = 100
V3_MAX_ITER = 64  # replicate 1 runs into it on v3's CSR


def random_csr(rng, R, T, max_k):
    """`test_torch_em.random_csr` (whose module imports the JAX package,
    which a card's machine lacks): R reads of 1 to `max_k` alignments to
    T transcripts, log-normal weights."""
    sizes = rng.integers(1, max_k + 1, size=R)
    boundaries = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    txp_id = rng.integers(0, T, size=int(sizes.sum())).astype(np.int32)
    w = np.exp(rng.normal(0, 1, size=len(txp_id))).astype(np.float64)
    read_id = np.repeat(np.arange(R, dtype=np.int32), sizes)
    return txp_id, w, boundaries, read_id, R, T


class Problem:
    """One formulation's layout of the CSR, the start, the read order of
    its multiplicities, its `max_iter`, and each replicate's run alone
    (made on first use)."""

    def __init__(self, impl, csr):
        txp_id, w, boundaries, read_id, R, T = csr
        self.order, self.max_iter = None, MAX_ITER
        if impl == "v3":
            self.data, self.order = tv3.EmV3Data.build(
                txp_id, w, boundaries, T, device="cpu")
            dtype, run, steps = torch.float32, tv3.run_em_v3, tv3
            self.max_iter = V3_MAX_ITER
        elif impl == "v4":
            self.data, self.order = tv4.EmV4Data.build(
                txp_id, w, boundaries, T, device="cpu")
            assert tv4._batch_eligible(self.data)
            dtype, run, steps = torch.float32, tv4.run_em_v4, tv4
        elif impl == "fast":
            self.data, self.order = tfast.FastEmData.build(
                txp_id, w, boundaries, T, dtype=torch.float32, device="cpu")
            dtype, run, steps = torch.float32, tfast.run_em_fast, tfast
        else:
            self.data = tem.EmData.build(txp_id, w, read_id, R, T,
                                         dtype=torch.float64, device="cpu")
            dtype, run, steps = torch.float64, tem.run_em, tem
        self.num_reads, self.run = R, run
        self.init = torch.full((T,), R / T, dtype=dtype)
        self.mult = self.ordered(boot.sample_multiplicities(
            np.random.default_rng(MULT_SEED), N_MAX, R))
        self.steps = steps
        self._singles = {}

    def ordered(self, mult):
        return mult if self.order is None else mult[:, self.order]

    def single(self, b):
        if b not in self._singles:
            m = torch.from_numpy(self.mult[b]).to(self.init.dtype)
            counts, niter = self.run(self.data, self.init, self.max_iter,
                                     THRESH, multiplicity=m)
            self._singles[b] = (counts.double().numpy(), int(niter))
        return self._singles[b]


@pytest.fixture(scope="module")
def problems():
    csr = random_csr(np.random.default_rng(1), 1000, 100, 12)
    out = {impl: Problem(impl, csr) for impl in ("v4", "fast", "segsum")}
    out["v3"] = Problem("v3", random_csr(np.random.default_rng(1), 5000,
                                         500, 12))
    return out


def list_schedule(steps, batch):
    """(batch m-steps, those with a slot empty) of jobs of `steps` m-steps
    each, taken in order by the first of `batch` slots to come free."""
    free = [0] * batch
    for s in steps:
        heapq.heappush(free, heapq.heappop(free) + s)
    # a slot is empty from the end of its last job on
    return max(free), max(free) - min(free)


CASES = [(1, 7, "array"), (3, 13, "stream"), (8, 1, "array"),
         (8, 8, "stream"), (8, 13, "slow"), (8, N_MAX, "stream")]
ALL_CASES = ([(impl, *case) for impl in ("v4", "fast", "segsum")
              for case in CASES]
             + [("v3", 1, 2, "array"), ("v3", 1, 2, "stream")])


@pytest.mark.parametrize(
    "impl,batch,n,source", ALL_CASES,
    ids=[f"{i}-{b}-slots-{n}-{s}" for i, b, n, s in ALL_CASES])
def test_pool_equals_single_runs(problems, caplog, impl, batch, n, source):
    p = problems[impl]
    if source == "array":
        mult = p.mult[:n]
    else:
        rng = np.random.default_rng(MULT_SEED)
        if source == "slow":
            rng = SlowRng(rng, 0.05)
        mult = boot.DrawStream(rng, n, p.num_reads)
        mult.set_order(p.order)
    step = p.steps.replicate_step(p.data, p.max_iter, THRESH)
    try:
        with caplog.at_level(logging.INFO, logger=LOGGER):
            counts, iters = boot.run_replicates(step, mult, p.init, batch)
    finally:
        if source != "array":
            mult.close()
    assert counts.shape == (n, p.init.shape[0]) and counts.dtype == np.float64
    assert iters.shape == (n,)
    for b in range(n):
        want, niter = p.single(b)
        assert int(iters[b]) == niter, b
        np.testing.assert_array_equal(counts[b], want, err_msg=str(b))
    if impl == "v3":
        assert iters.tolist() == [62, V3_MAX_ITER]
    elif n > 2:
        assert iters.min() == 52 and iters.max() == MAX_ITER
    attrs = batches_attrs(caplog)
    msteps, tail = list_schedule([int(i) + 1 for i in iters], batch)
    assert attrs["msteps"] == msteps
    assert attrs["tail_steps"] == tail
    assert attrs["slot_steps"] == attrs["useful_steps"] == iters.sum() + n
    assert attrs["refills"] == max(0, n - batch)
    assert attrs["batches"] == -(-n // batch) and attrs["batch"] == batch
    assert attrs["draws_waited"] <= attrs["batches"]


@pytest.mark.parametrize("impl", ["v4", "segsum"])
def test_squarem_pool_equals_single_runs(problems, impl):
    """With `--em-accel squarem` a slot runs a cycle of three m-steps a
    step and its final step inside the next cycle: every replicate's
    iterations are those of its accelerated run alone, and its counts too
    (v4 at rtol 1e-5: a cycle's step length is a ratio of sums over the
    transcripts, which a batch may add in another order)."""
    p = problems[impl]
    run = tv4.run_em_v4_squarem if impl == "v4" else tem.run_em_squarem
    step = p.steps.replicate_step(p.data, MAX_ITER, THRESH, accel="squarem")
    counts, iters = boot.run_replicates(step, p.mult[:7], p.init, 3)
    for b in range(7):
        m = torch.from_numpy(p.mult[b]).to(p.init.dtype)
        want, niter = run(p.data, p.init, MAX_ITER, THRESH, multiplicity=m)
        assert int(iters[b]) == int(niter), b
        np.testing.assert_allclose(counts[b], want.double().numpy(),
                                   rtol=1e-5 if impl == "v4" else 1e-12)


def check_card_pool(build, run, steps, reads):
    """Replicates 0, 96 and the slowest of 100 out of the pool of 8 slots
    on the card, on a CSR of `reads` reads (a tenth as many transcripts)
    laid out by `build`, against their single runs through `run`: the
    same iterations, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    txp_id, w, boundaries, _, R, T = random_csr(
        np.random.default_rng(2), reads, reads // 10, 12)
    data, order = build(txp_id, w, boundaries, T)
    init = torch.full((T,), R / T, dtype=torch.float32, device="cuda")
    mult = boot.DrawStream(np.random.default_rng(MULT_SEED), N_MAX, R)
    try:
        mult.set_order(order)
        counts, iters = boot.run_replicates(
            steps.replicate_step(data, 1000, THRESH), mult, init)
        for b in sorted({0, 96, int(np.argmax(iters))}):
            m = torch.as_tensor(mult[b], device="cuda").float()
            want, niter = run(data, init, 1000, THRESH, multiplicity=m)
            assert int(iters[b]) == int(niter), b
            np.testing.assert_array_equal(counts[b],
                                          want.double().cpu().numpy())
    finally:
        mult.close()
    assert iters.max() > iters.min()


@pytest.mark.cuda
def test_pool_on_the_card_equals_single_runs():
    """On the card a replicate's batched step has the bits of its step
    alone (the kernels' replicate arms, the fixed-order row sums), so the
    pool gives v4's replicates the iterations and bits of their single
    runs."""

    def build(txp_id, w, boundaries, T):
        data, order = tv4.EmV4Data.build(txp_id, w, boundaries, T,
                                         device="cuda")
        assert tv4._batch_eligible(data)
        return data, order

    check_card_pool(build, tv4.run_em_v4, tv4, 200_000)


@pytest.mark.cuda
def test_pallas_pool_on_the_card_equals_single_runs():
    """The same for `--em-impl pallas`, whose batched step the pool's tail
    runs at every B from 8 down to 1 (K1's batch arm, the dense row sums
    and tile cumsums over a leading replicate axis), on 20,000 reads: at
    200,000 its f32 cumsum differences move abundances near 1e-5 by up to
    half their value, every step, and no replicate converges."""

    def build(txp_id, w, boundaries, T):
        return tfast.FastEmData.build(
            txp_id, w, boundaries, T, dtype=torch.float32,
            use_pallas_gather=True, device="cuda")

    check_card_pool(build, tfast.run_em_fast, tfast, 20_000)
