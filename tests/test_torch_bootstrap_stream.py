"""`ops/bootstrap.py::DrawStream`: the bootstrap multiplicities drawn on a
thread of their own, a batch at a time from the seed's one stream.

Its rows equal `sample_multiplicities(...)[:, order]` bit for bit, as
drawn and in a v4-style read order (pad rows on read 0), with the order
given before or after the draw; the CLI's `.infreps.pq` equals, byte for
byte, that of the same run with the array draw in the stream's place; a
run whose route raises leaves no drawing thread; an error on the thread
reaches the consumer; and `boot.batches` counts the batches' waits for
the draw (`draw_wait_s`, `draws_waited`).
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.ops import bootstrap as boot
from oarfish_tpu_torch.ops import em
from oarfish_tpu_torch.quant import bulk
from oarfish_tpu_torch.utils import trace
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

LOGGER = "oarfish_tpu_torch"
SEED = 2**31 + 7
R_CLI, T_CLI = 40_000, 2_000  # v4 routes it on the CPU


def v4_style_order(rng, R):
    """A read order of padded bucket rows: every read once, a fifth more
    rows of padding that point to read 0, as `EmV4Data.build` gives it."""
    order = np.zeros(R + R // 5, dtype=np.int64)
    rows = np.sort(rng.choice(len(order), R, replace=False))
    order[rows] = rng.permutation(R)
    return order


class SlowRng:
    """A generator whose every `multinomial` call sleeps first."""

    def __init__(self, rng, delay):
        self.rng, self.delay = rng, delay

    def multinomial(self, *args, **kwargs):
        time.sleep(self.delay)
        return self.rng.multinomial(*args, **kwargs)


class FailingRng:
    def multinomial(self, *args, **kwargs):
        raise ValueError("bad draw")


class ArrayDraw:
    """The array draw in the stream's place: every replicate at once as
    float64, then the fancy index into the read order."""

    def __init__(self, rng, num_boot, num_reads, batch=boot.BOOT_BATCH):
        self.mult = boot.sample_multiplicities(rng, num_boot, num_reads)

    def set_order(self, order):
        if order is not None:
            self.mult = self.mult[:, order]

    def close(self):
        pass

    def __len__(self):
        return len(self.mult)

    def __getitem__(self, key):
        return self.mult[key]


def draw_threads():
    return [t for t in threading.enumerate() if t.name == "boot-draw"]


@pytest.mark.parametrize("num_boot,batch", [(100, 8), (5, 8), (7, 1)],
                         ids=["100-by-8", "5-by-8", "7-by-1"])
@pytest.mark.parametrize("order_given", ["none", "v4", "v4-late"])
def test_rows_equal_the_array_draw(num_boot, batch, order_given):
    R = 3_000
    order = None
    if order_given != "none":
        order = v4_style_order(np.random.default_rng(1), R)
    want = boot.sample_multiplicities(np.random.default_rng(SEED),
                                      num_boot, R)
    if order is not None:
        want = want[:, order]
    stream = boot.DrawStream(np.random.default_rng(SEED), num_boot, R, batch)
    try:
        if order_given == "v4-late":
            # the batches are drawn before the order is known
            time.sleep(0.2)
        stream.set_order(order)
        got = stream[:]
        assert len(stream) == num_boot
        assert got.dtype == np.int32 and got.shape == want.shape
        assert np.array_equal(got, want)
        assert np.array_equal(stream[num_boot - 1], want[-1])
        assert np.array_equal(stream[batch:2 * batch], want[batch:2 * batch])
    finally:
        stream.close()
    assert not draw_threads()


@pytest.fixture(scope="module")
def cli_bam(tmp_path_factory):
    from chip_smoke import build_e2e_bam

    bam = tmp_path_factory.mktemp("stream") / "x.bam"
    build_e2e_bam(bam, R_CLI, T_CLI, seed=3, threads=2)
    return bam


def cli(bam, out, *extra):
    return torch_main(["--alignments", str(bam), "--device", "cpu",
                       "--max-em-iter", "2", "--seed", "5", "-o", str(out),
                       *extra])


@pytest.mark.parametrize("impl", ["segsum", "v4"])
def test_cli_replicates_equal_the_array_draw(cli_bam, tmp_path, monkeypatch,
                                             impl):
    args = ["--em-impl", impl, "--num-bootstraps", "10"]
    assert cli(cli_bam, tmp_path / "stream", *args) == 0
    monkeypatch.setattr(boot, "DrawStream", ArrayDraw)
    assert cli(cli_bam, tmp_path / "array", *args) == 0
    streamed = (tmp_path / "stream.infreps.pq").read_bytes()
    assert streamed == (tmp_path / "array.infreps.pq").read_bytes()
    assert not draw_threads()


def test_a_run_whose_route_raises_leaves_no_drawing_thread(
        cli_bam, tmp_path, monkeypatch):
    real = boot.DrawStream
    # 25 batches of 0.1 s each: the draw outlives the route by far
    monkeypatch.setattr(boot, "DrawStream", lambda rng, *a, **k: real(
        SlowRng(rng, 0.1), *a, **k))

    def no_route(*args, **kwargs):
        raise ValueError("no route")

    monkeypatch.setattr(bulk, "build_em_inputs", no_route)
    with pytest.raises(ValueError, match="no route"):
        cli(cli_bam, tmp_path / "out", "--em-impl", "segsum",
            "--num-bootstraps", "200")
    deadline = time.monotonic() + 2.0
    while draw_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not draw_threads()


# an EM's stand-in: a replicate's counts are its multiplicities' total,
# after one iteration
PLAIN_STEP = em.BatchStep(
    lambda prev, m: m.sum(dim=1, keepdim=True).expand_as(prev).clone(),
    max_iter=1, convergence_thresh=0.0)


def batches_attrs(caplog):
    [s] = [s for s in (trace.parse(r.getMessage()) for r in caplog.records)
           if s is not None and s.name == "boot.batches"]
    return s.attrs


def run_batches(caplog, stream):
    init = torch.zeros(4, dtype=torch.float64)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        counts, iters = boot.run_replicates(PLAIN_STEP, stream, init)
    want = boot.sample_multiplicities(np.random.default_rng(3), 16, 500)
    assert np.array_equal(counts[:, 0], want.sum(axis=1))
    assert iters.tolist() == [1] * 16
    return batches_attrs(caplog)


def test_a_slow_draw_makes_the_batches_wait(caplog):
    stream = boot.DrawStream(SlowRng(np.random.default_rng(3), 0.2), 16, 500)
    try:
        stream.set_order(None)
        attrs = run_batches(caplog, stream)
    finally:
        stream.close()
    assert 1 <= attrs["draws_waited"] <= attrs["batches"] == 2
    assert attrs["draw_wait_s"] >= 0.1


def test_rows_written_before_the_batches_are_not_waited_for(caplog):
    stream = boot.DrawStream(np.random.default_rng(3), 16, 500)
    try:
        stream.set_order(None)
        stream[:]  # every row written
        attrs = run_batches(caplog, stream)
    finally:
        stream.close()
    assert attrs["draws_waited"] == 0
    assert attrs["draw_wait_s"] == pytest.approx(0.0, abs=1e-6)


def test_an_error_in_the_draw_reaches_the_consumer():
    stream = boot.DrawStream(FailingRng(), 16, 500)
    try:
        stream.set_order(None)
        with pytest.raises(ValueError, match="bad draw"):
            stream[0]
    finally:
        stream.close()


def test_a_closed_stream_stops_between_batches_and_gives_no_rows():
    # ten batches of 0.2 s each, and no read order ever given
    stream = boot.DrawStream(SlowRng(np.random.default_rng(3), 0.2), 80, 500)
    t0 = time.monotonic()
    stream.close()
    assert time.monotonic() - t0 < 1.0
    assert not draw_threads()
    with pytest.raises(RuntimeError, match="closed"):
        stream[79]
