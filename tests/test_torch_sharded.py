"""The read-sharded segment-sum EM of the torch port (`parallel/sharded_em.py`,
`parallel/multihost.py`) against the JAX package's on its virtual 8-device
CPU mesh, and single-cell mode spread over a device list.

The JAX side runs `sharded_em`, `sharded_em_global_local` and
`split_bootstrap_multiplicities` directly; the port runs every shard on the
CPU (one device list of one `cpu`, so several shards share it, as they
share one card on the GPU machine).

Tolerances, all f64: rtol 1e-9 (atol 1e-9) for whole EM runs, the bar the
JAX package holds its sharded EM to against the NumPy oracle; the shards'
partial counts are added in another order than the JAX package's `psum`.
`ShardedCsr` arrays and the bootstrap multiplicities: equal. Single cell:
the output files byte-equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.cli import main as jax_main
from oarfish_tpu.parallel import multihost as jmh
from oarfish_tpu.parallel import sharded_em as jse
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.ops import em as tem
from oarfish_tpu_torch.ops.convert import (
    SHARDED_CSR_ARRAYS,
    sharded_csr_from_numpy,
)
from oarfish_tpu_torch.ops.em_oracle import do_em_oracle
from oarfish_tpu_torch.parallel import multihost as tmh
from oarfish_tpu_torch.parallel import sharded_em as tse
from oarfish_tpu_torch.quant import single_cell as tsc
from test_em import random_csr
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = [torch.device("cpu")]
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def csr():
    """`tests/test_sharded.py`'s CSR of the shard-count test."""
    rng = np.random.default_rng(2)
    txp_id, w, boundaries, _, R, T = random_csr(rng, R=203, T=30)
    return txp_id, w, boundaries, R, T, np.full(T, R / T)


@pytest.mark.parametrize("D", [2, 3, 8])
def test_sharded_csr_equals_jax(csr, D):
    txp_id, w, boundaries, R, T, _ = csr
    want = jse.ShardedCsr(txp_id, w, boundaries, T, D)
    got = tse.ShardedCsr(txp_id, w, boundaries, T, D)
    assert got.read_ranges == want.read_ranges
    assert (got.r_pad, got.a_pad) == (want.r_pad, want.a_pad)
    for k in SHARDED_CSR_ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    mult = np.random.default_rng(D).poisson(1.0, size=(2, R)).astype(float)
    np.testing.assert_array_equal(got.shard_multiplicity(mult),
                                  want.shard_multiplicity(mult))


@pytest.mark.parametrize("accel", ["none", "squarem"])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_sharded_em_matches_jax(csr, D, accel):
    txp_id, w, boundaries, R, T, init = csr
    want, jn = jse.sharded_em(txp_id, w, boundaries, T, init, max_iter=120,
                              convergence_thresh=1e-3, dtype=jnp.float64,
                              num_shards=D, accel=accel)
    got, n = tse.sharded_em(txp_id, w, boundaries, T, init, max_iter=120,
                            convergence_thresh=1e-3, dtype=torch.float64,
                            devices=CPU, num_shards=D, accel=accel)
    assert n == int(jn)
    np.testing.assert_allclose(got, want, **TOL)
    if accel == "none":
        oracle = do_em_oracle(txp_id, w, boundaries, T, max_iter=120)
        np.testing.assert_allclose(got, oracle, **TOL)


def test_the_jax_tables_give_the_same_run(csr):
    """The port's m-step on the JAX package's own shard tables."""
    txp_id, w, boundaries, R, T, init = csr
    jsh = jse.ShardedCsr(txp_id, w, boundaries, T, 3)
    sh = sharded_csr_from_numpy(
        {k: getattr(jsh, k) for k in SHARDED_CSR_ARRAYS}, jsh.read_ranges,
        T, R, jsh.r_pad)
    mesh = tse.ShardMesh.local(CPU * 3)
    run = tse.make_sharded_em(mesh, T, sh.r_pad, 120, dtype=torch.float64)
    counts, _ = run([sh.shard_data(d, torch.float64, "cpu") for d in range(3)],
                    tse.padded_init(init, torch.float64, "cpu"), 1e-3)
    want, _ = tse.sharded_em(txp_id, w, boundaries, T, init, max_iter=120,
                             dtype=torch.float64, devices=CPU, num_shards=3)
    np.testing.assert_array_equal(counts.numpy()[:T], want)


def test_more_shards_than_devices_give_the_unsharded_counts(csr):
    """Four shards on one device quantify all reads: the unsharded EM's
    counts and the reads' mass. (The JAX package's `sharded_em` puts four
    shards on `devices[:4]`, one device here, and keeps shard 0's reads
    alone.)"""
    txp_id, w, boundaries, R, T, init = csr
    got, n = tse.sharded_em(txp_id, w, boundaries, T, init, max_iter=120,
                            dtype=torch.float64, devices=CPU, num_shards=4)
    data = tem.EmData.build(txp_id, w, np.repeat(np.arange(R),
                                                 np.diff(boundaries)),
                            R, T, dtype=torch.float64, device="cpu")
    want, wn = tem.run_em(data, torch.as_tensor(init), 120, 1e-3)
    assert n == int(wn)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    assert abs(got.sum() - R) < 1e-9 * R


def test_bootstrap_multiplicities_run_like_jax(csr):
    """`with_mult`: replicates over sharded reads through
    `sharded_em_global_local` (one process), against the JAX package's."""
    txp_id, w, boundaries, R, T, init = csr
    mult = np.random.default_rng(4).multinomial(
        R, np.full(R, 1.0 / R), size=2).astype(np.float64)
    kw = dict(max_iter=120, convergence_thresh=1e-3)
    want, jn = jmh.sharded_em_global_local(
        txp_id, w, boundaries, T, init, dtype=jnp.float64, mult_local=mult,
        **kw)
    got, n = tmh.sharded_em_global_local(
        txp_id, w, boundaries, T, init, dtype=torch.float64,
        mesh=tse.ShardMesh.local(CPU * 3), mult_local=mult, **kw)
    assert n == list(jn)
    np.testing.assert_allclose(got, want, **TOL)
    plain, _ = tmh.sharded_em_global_local(
        txp_id, w, boundaries, T, init, dtype=torch.float64,
        mesh=tse.ShardMesh.local(CPU * 3), **kw)
    one, _ = tmh.sharded_em_global(txp_id, w, boundaries, T, init,
                                   dtype=torch.float64,
                                   mesh=tmh.global_data_mesh("cpu"), **kw)
    np.testing.assert_allclose(plain, one, **TOL)


@pytest.mark.parametrize("pidx", [0, 1])
def test_split_bootstrap_multiplicities_equal_jax(monkeypatch, pidx):
    """Process `pidx` of two, with 70 and 50 local reads: the same draws."""
    r_locals = np.array([[70], [50]], dtype=np.int64)
    monkeypatch.setattr(jmh, "allgather_hosts", lambda x: r_locals)
    monkeypatch.setattr(jmh.jax, "process_index", lambda: pidx)
    monkeypatch.setattr(tmh, "allgather_hosts", lambda x: r_locals)
    monkeypatch.setattr(tmh, "process_index", lambda: pidx)
    n = int(r_locals[pidx, 0])
    want = jmh.split_bootstrap_multiplicities(3, n, seed=11)
    got = tmh.split_bootstrap_multiplicities(3, n, seed=11)
    assert got.shape == (3, n)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def sc_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("sc")
    simulate_bam(d / "sc.bam", num_reads=240, seed=45,
                 barcodes=[f"BC{i:02d}" for i in range(6)],
                 names=[f"t{i}" for i in range(8)],
                 lengths=[1000 + 100 * i for i in range(8)])
    return d


SC_FILES = [".count.mtx", ".features.txt", ".barcodes.txt"]


def test_single_cell_over_two_devices_is_byte_equal(sc_bam, monkeypatch):
    """`--single-cell --num-shards 2`: on the CPU one device, the JAX CLI
    two (its virtual mesh); then the port's branch of two devices, driven
    on `[cpu, cpu]`. All byte-equal to the single-device run."""
    monkeypatch.chdir(sc_bam)
    monkeypatch.setenv("OARFISH_JAX_CACHE", "0")
    argv = ["--alignments", "sc.bam", "--single-cell", "--em-dtype",
            "float64", "--quiet"]
    assert torch_main(argv + ["-o", "one", "--device", "cpu"]) == 0
    assert torch_main(argv + ["-o", "two", "--device", "cpu",
                              "--num-shards", "2"]) == 0
    assert jax_main(argv + ["-o", "jax", "--num-shards", "2"]) == 0
    seen = []
    real = tsc.cell_devices

    def two_cpus(args, device):
        assert real(args, device) == [device]
        seen.append(args.num_shards)
        return [device, device]

    monkeypatch.setattr(tsc, "cell_devices", two_cpus)
    assert torch_main(argv + ["-o", "split", "--device", "cpu",
                              "--num-shards", "2"]) == 0
    assert seen == [2]
    for ext in SC_FILES:
        one = (sc_bam / f"one{ext}").read_bytes()
        for tag in ("two", "jax", "split"):
            assert (sc_bam / f"{tag}{ext}").read_bytes() == one, (tag, ext)
    meta = json.loads((sc_bam / "split.meta_info.json").read_text())
    assert meta["single_cell"] is True
