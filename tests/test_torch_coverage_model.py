"""The device coverage model of the torch port vs the JAX package's, the
NumPy oracle and the native host pass.

The same seeded stores (built by `test_coverage_model.build_store`) go
through `coverage_jax` (JAX on the CPU, x64), through the oracle
`logistic_prob_np` / `normalize_read_probs_np`, through the port's native
host pass and through `coverage_torch` on `device="cpu"`.

Tolerance: rtol 1e-12 (atol 0), the JAX package's own bar for its device
model: the per-transcript and per-read sums add in another order, `exp` is
another library's, and at these sizes (a few hundred bins) the prefix sums
stay small; the one exception, against the JAX model only, is stated at
`JAX_RTOL`. The CLI with `OARFISH_COVMODEL=torch` must write the pinned golden
files byte for byte.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from oarfish_tpu.models.coverage import (
    logistic_prob_np,
    normalize_read_probs_np,
)
from oarfish_tpu.models.coverage_jax import (
    logistic_prob_jax,
    normalize_read_probs_jax,
)
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.models import coverage as tcov
from oarfish_tpu_torch.models import coverage_torch as tcovt
from oarfish_tpu_torch.quant import bulk as tbulk
from test_coverage_model import build_store
from test_torch_bulk_e2e import BASE, GOLDEN, RUNS, golden_transcripts
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

# seed, transcripts, reads: the JAX package's two cases, then one with
# transcripts that no read hits (inactive: probability 0)
STORES = [(3, 7, 300), (4, 7, 300), (5, 40, 60)]
# In the third store runs of inactive bins (probability 0) follow active
# ones, so an interior sum of 1e-5 is the difference of prefix sums of 1e2:
# `jnp.cumsum` adds in another order than a serial sum and the JAX model
# itself is 3.6e-10 off the oracle there. The port, whose prefix sums are
# serial, stays within 1e-12 of the oracle and the host pass.
JAX_RTOL = {5: 1e-9}


def fresh(seed, T, R):
    rng = np.random.default_rng(seed)
    store, cov, _ = build_store(rng, T=T, R=R)
    return store, cov


@pytest.mark.parametrize("seed,T,R", STORES)
def test_logistic_prob_matches_jax_oracle_and_native(seed, T, R):
    _, cov = fresh(seed, T, R)
    cov_j, cov_np, cov_nat = (copy.deepcopy(cov) for _ in range(3))
    if seed == 5:
        assert (cov.total_weight == 0).any(), "no inactive transcript"
    got = tcovt.logistic_prob_torch(cov, 2.0, device="cpu")
    assert got.dtype == np.float64 and got.shape == cov.bins.shape
    for name, want, other in (
        ("jax", logistic_prob_jax(cov_j, 2.0), cov_j),
        ("oracle", logistic_prob_np(cov_np, 2.0), cov_np),
        ("native", tcov.logistic_prob(cov_nat, 2.0, threads=2), cov_nat),
    ):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=name)
        # the pseudo-count went into the bins, once
        np.testing.assert_allclose(cov.bins, other.bins, rtol=1e-15,
                                   err_msg=name)
    assert ((got == 0) == np.repeat(cov.total_weight == 0, cov.nbins)).all()


@pytest.mark.parametrize("seed,T,R", STORES)
def test_normalize_read_probs_matches_jax_oracle_and_native(seed, T, R):
    store, cov = fresh(seed, T, R)
    flat = logistic_prob_np(cov, 2.0)
    want = {}
    for name, fn in (
        ("jax", lambda s: normalize_read_probs_jax(s, cov, flat, 100)),
        ("oracle", lambda s: normalize_read_probs_np(s, cov, flat, 100)),
        ("native", lambda s: tcov.normalize_read_probs(s, cov, flat, 100,
                                                       threads=2)),
    ):
        s = copy.deepcopy(store)
        fn(s)
        want[name] = s.cov_prob.copy()
    tcovt.normalize_read_probs_torch(store, cov, flat, 100, device="cpu")
    for name, w in want.items():
        np.testing.assert_allclose(store.cov_prob, w, atol=0, err_msg=name,
                                   rtol=JAX_RTOL.get(seed, 1e-12)
                                   if name == "jax" else 1e-12)
    # every read's probabilities sum to 1
    sums = np.add.reduceat(store.cov_prob, store.boundaries[:-1])
    np.testing.assert_allclose(sums, 1.0, rtol=1e-12)


def test_second_run_is_bit_identical():
    store, cov = fresh(3, 7, 300)
    cov2, store2 = copy.deepcopy(cov), copy.deepcopy(store)
    a = tcovt.logistic_prob_torch(cov, 2.0, device="cpu")
    b = tcovt.logistic_prob_torch(cov2, 2.0, device="cpu")
    assert a.tobytes() == b.tobytes()
    tcovt.normalize_read_probs_torch(store, cov, a, 100, device="cpu")
    tcovt.normalize_read_probs_torch(store2, cov2, b, 100, device="cpu")
    assert store.cov_prob.tobytes() == store2.cov_prob.tobytes()


def test_empty_alignment_is_an_error_as_on_the_host():
    """An alignment of length 0 inside one bin is the reference's 0/0."""
    store, cov = fresh(4, 7, 300)
    flat = logistic_prob_np(cov, 2.0)
    store.end[5] = store.start[5]
    with pytest.raises(FloatingPointError, match="normalize_read_probs"):
        tcovt.normalize_read_probs_torch(store, cov, flat, 100, device="cpu")
    with pytest.raises(FloatingPointError, match="normalize_read_probs"):
        normalize_read_probs_np(copy.deepcopy(store), cov, flat, 100)


def test_default_device_is_cuda():
    """No device named: the card or an error, never a quiet pass on the
    host."""
    store, cov = fresh(3, 7, 300)
    if torch.cuda.is_available():
        flat = tcovt.logistic_prob_torch(cov, 2.0)
        tcovt.normalize_read_probs_torch(store, cov, flat, 100)
        assert np.isfinite(store.cov_prob).all()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcovt.logistic_prob_torch(cov, 2.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcovt.normalize_read_probs_torch(store, cov, cov.bins, 100)


@pytest.mark.parametrize("ext", RUNS["bulk_cov"][3])
def test_cli_with_the_device_model_equals_golden(tmp_path, monkeypatch, ext):
    """`OARFISH_COVMODEL=torch --device cpu` on the BAM behind
    `tests/golden/bulk_cov`: the files are the pinned ones, and the device
    model is what ran."""
    n, seed, extra, _ = RUNS["bulk_cov"]
    names, lengths = golden_transcripts()
    bam = tmp_path / "cov.bam"
    simulate_bam(bam, num_reads=n, seed=seed, names=names, lengths=lengths)
    calls = []
    real = tbulk.normalize_read_probs_torch

    def spy(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tbulk, "normalize_read_probs_torch", spy)
    argv = ["--alignments", str(bam), *BASE, *extra, "--device", "cpu"]
    monkeypatch.delenv("OARFISH_COVMODEL", raising=False)
    assert torch_main(argv + ["-o", str(tmp_path / "host")]) == 0
    assert not calls  # the native host pass is the default
    monkeypatch.setenv("OARFISH_COVMODEL", "torch")
    assert torch_main(argv + ["-o", str(tmp_path / "dev")]) == 0
    assert [str(d) for d in calls] == ["cpu"]
    got = Path(str(tmp_path / "dev") + ext).read_bytes()
    assert got == (GOLDEN / "bulk_cov" / f"out{ext}").read_bytes()
    assert got == Path(str(tmp_path / "host") + ext).read_bytes()


@pytest.mark.cuda
def test_device_model_on_the_card_equals_the_host_pass():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store, cov = fresh(5, 40, 600)
    cov_h, store_h = copy.deepcopy(cov), copy.deepcopy(store)
    flat = tcovt.logistic_prob_torch(cov, 2.0)
    flat_h = tcov.logistic_prob(cov_h, 2.0)
    np.testing.assert_allclose(flat, flat_h, rtol=1e-12, atol=0)
    tcov.normalize_read_probs(store_h, cov_h, flat_h, 100)
    tcovt.normalize_read_probs_torch(store, cov, flat, 100)
    np.testing.assert_allclose(store.cov_prob, store_h.cov_prob,
                               rtol=1e-12, atol=0)
