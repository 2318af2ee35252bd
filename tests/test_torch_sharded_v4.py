"""The read-sharded v4 EM of the torch port (`parallel/sharded_v4.py`, with
the envelope code of `ops/em_v4.py`) against the JAX package's
(`parallel/sharded_v4.py`) on a zipf-skewed CSR of `tests/test_sharded_v4.py`'s
kind, cut to R = 16,000 reads and T = 800 transcripts (two and four shards
still route, with big transcripts in every shard). Each package builds the
shards once per module; the JAX EM runs through `make_sharded_v4_runner` on
its 8-device CPU mesh (its Pallas kernels in interpret mode), the port's on
the CPU, every shard there.

Tolerances:

* per-shard layouts, route tables, tile permutes, level tables, geometry,
  `t_space`, read orders, and the weights of an f32 build: equal.
* the EM on the JAX package's own tables (`ops/convert.sharded_v4_from_jax`),
  f64: rtol 1e-9 (atol 1e-9), the shards' partials added in another order
  than the `psum`'s. The port's own f64 build keeps the weights in f64 where
  the JAX package rounds them to f32 (`EmV4Data.w_txp`), so against the
  NumPy oracle it is held at rtol 1e-9 too, and the JAX package's run at
  rtol 1e-5 (the JAX package's own bar against the oracle).
* bootstrap batches and a multiplicity run against the port's
  single-device v4 EM on the same replicates, f64: rtol 1e-8 (the JAX
  package's bar), the same iterations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from oarfish_tpu.parallel import sharded_v4 as jsv
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops.convert import V4_META, sharded_v4_from_jax
from oarfish_tpu_torch.ops.em_oracle import do_em_oracle
from oarfish_tpu_torch.ops.static_permute import ROUTE_TABLES
from oarfish_tpu_torch.parallel import sharded_v4 as tsv
from test_em import random_csr
from test_torch_static_permute import route_fields, tile_fields
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

R, T = 16_000, 800
ITERS, CONV = 5, 5e-3
CPU = [torch.device("cpu")]


def skewed_csr():
    rng = np.random.default_rng(21)
    txp_id, w, boundaries, _, _, _ = random_csr(rng, R=R, T=T, max_k=4)
    txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)
    return txp_id, w, boundaries


def unstack(jdata, d):
    """Shard d of the JAX package's stacked `ShardedV4.data`."""
    def at(x):
        return None if x is None else np.asarray(x)[d]

    return {
        "w_txp": at(jdata.w_txp), "seg_id": at(jdata.seg_id),
        "big_row_of_txp": at(jdata.big_row_of_txp),
        "big_row_offsets": at(jdata.big_row_offsets),
        **{f"{r}.{k}": at(getattr(getattr(jdata, r), k))
           for r in ("p_a", "p_b") for k in ROUTE_TABLES},
        **{f"{t}.{k}": at(getattr(getattr(jdata, t), k))
           for t in ("t_in", "t_out") for k in ("r1", "r2", "src", "lane")},
    }


def carried(jsh, dtype):
    """The JAX package's shards as the port's, on the CPU."""
    jd = jsh.data
    return sharded_v4_from_jax(
        np.asarray(jd.w_txp), route_fields(jd.p_a), route_fields(jd.p_b),
        tile_fields(jd.t_in), tile_fields(jd.t_out),
        np.asarray(jd.big_row_of_txp), np.asarray(jd.big_row_offsets),
        None if jd.seg_id is None else np.asarray(jd.seg_id),
        {k: getattr(jd, k) for k in V4_META}, jsh.read_ranges,
        jsh.read_orders, dtype, CPU * jsh.num_shards)


@pytest.fixture(scope="module")
def cases():
    """Per shard count: both packages' builds and the JAX package's run."""
    csr = skewed_csr()
    init = np.full(T, R / T)
    out = {}
    for D in (2, 4):
        jsh, mesh = jsv.build_sharded_v4(*csr, T, num_shards=D)
        want, jn = jsv.make_sharded_v4_runner(mesh, ITERS)(
            jsh.data, jnp.asarray(init), jnp.asarray(CONV), None)
        out[D] = dict(
            jsh=jsh, want=np.asarray(want), jn=int(jn),
            t32=tsv.ShardedV4(*csr, T, D, devices=CPU * D),
            t64=tsv.build_sharded_v4(*csr, T, devices=CPU, num_shards=D,
                                     dtype=torch.float64),
        )
    return csr, init, out


@pytest.mark.parametrize("D", [2, 4])
def test_shards_equal_jax(cases, D):
    _, _, c = cases
    jsh, sh = c[D]["jsh"], c[D]["t32"]
    assert sh.read_ranges == jsh.read_ranges
    assert (sh.row_space_r, sh.t_space) == (jsh.row_space_r,
                                            int(jsh.data.t_space))
    assert all(d.n_big > 0 for d in sh.datas)
    for d, data in enumerate(sh.datas):
        np.testing.assert_array_equal(sh.read_orders[d], jsh.read_orders[d])
        want = unstack(jsh.data, d)
        for key, val in want.items():
            obj = data
            for part in key.split("."):
                obj = getattr(obj, part)
            assert (obj is None) == (val is None), key
            if val is not None:
                np.testing.assert_array_equal(obj.numpy(), val, err_msg=key)
        for r in ("p_a", "p_b"):
            for k in ("n_src", "n_dst", "Q", "R1", "R3", "chunk_rows"):
                assert getattr(getattr(data, r), k) == getattr(
                    getattr(jsh.data, r), k), (r, k)
        for k in V4_META:
            assert getattr(data, k) == getattr(jsh.data, k), k


@pytest.mark.parametrize("D", [2, 4])
def test_em_on_the_jax_tables_matches_jax(cases, D):
    _, init, c = cases
    sh = carried(c[D]["jsh"], torch.float64)
    run = tsv.make_sharded_v4_runner(tsv.ShardMesh.local(CPU * D), ITERS)
    got, n = run(sh, torch.as_tensor(init), CONV)
    assert int(n) == c[D]["jn"] == ITERS
    np.testing.assert_allclose(got.numpy(), c[D]["want"], rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("D", [2, 4])
def test_own_build_matches_the_oracle_and_jax(cases, D):
    csr, init, c = cases
    sh, mesh = c[D]["t64"]
    got, n = tsv.make_sharded_v4_runner(mesh, ITERS)(
        sh, torch.as_tensor(init), CONV)
    got = got.numpy()
    want = do_em_oracle(*csr, T, max_iter=ITERS, convergence_thresh=CONV)
    assert abs(got.sum() - R) < 1e-9 * R
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, c[D]["want"], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def single(cases):
    """The port's single-device v4 state of the same CSR, f64."""
    csr, _, _ = cases
    return tv4.EmV4Data.build(*csr, T, dtype=torch.float64, device="cpu")


def test_bootstrap_batches_match_single_runs(cases, single):
    """Three replicates in batches of two (the last as short as it comes)
    over four shards, against one single-device run per replicate."""
    csr, init, c = cases
    sh, mesh = c[4]["t64"]
    mult = np.random.default_rng(29).multinomial(
        R, np.full(R, 1.0 / R), size=3).astype(np.float64)
    got, iters = tsv.sharded_v4_bootstrap(
        sh, mesh, init, mult, max_iter=ITERS, convergence_thresh=CONV,
        dtype=torch.float64, batch=2)
    assert got.shape == (3, T) and iters.tolist() == [ITERS] * 3
    data, order = single
    for b in range(3):
        want, n = tv4.run_em_v4(data, torch.as_tensor(init), ITERS, CONV,
                                multiplicity=torch.as_tensor(mult[b][order]))
        assert int(n) == iters[b]
        np.testing.assert_allclose(got[b], want.numpy(), rtol=1e-8,
                                   atol=1e-8)


def test_multiplicity_run_matches_single(cases, single):
    csr, init, _ = cases
    mult = np.random.default_rng(23).poisson(1.0, size=R).astype(np.float64)
    got, n = tsv.sharded_v4_em(*csr, T, init, max_iter=ITERS,
                               convergence_thresh=CONV, dtype=torch.float64,
                               devices=CPU, num_shards=4, multiplicity=mult)
    data, order = single
    want, wn = tv4.run_em_v4(data, torch.as_tensor(init), ITERS, CONV,
                             multiplicity=torch.as_tensor(mult[order]))
    assert n == int(wn)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-8, atol=1e-8)


def test_squarem_matches_the_unsharded_run(cases, single):
    """Three SQUAREM cycles over two shards, against the single-device
    v4 SQUAREM: the same m-steps, f64, rtol 1e-9."""
    csr, init, c = cases
    sh, mesh = c[2]["t64"]
    got, n = tsv.make_sharded_v4_runner(mesh, 9, min_iters=2,
                                        accel="squarem")(
        sh, torch.as_tensor(init), 1e-7)
    data, _ = single
    want, wn = tv4.run_em_v4_squarem(data, torch.as_tensor(init), 9, 1e-7,
                                     min_iters=2)
    assert int(n) == int(wn) == 9
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    from util_sim import simulate_bam

    d = tmp_path_factory.mktemp("bam")
    simulate_bam(d / "small.bam", num_reads=300, seed=5,
                 names=[f"t{i}" for i in range(9)],
                 lengths=[900 + 150 * i for i in range(9)])
    return d / "small.bam"


def read_counts(path):
    with open(path) as fh:
        return np.array([float(ln.split("\t")[2])
                         for ln in fh.readlines()[1:]])


@pytest.mark.parametrize("D", [2, 4])
def test_cli_runs_sharded_v4_with_bootstraps(small_bam, tmp_path, D, caplog):
    """`--num-shards D --em-impl v4 --num-bootstraps 2`, f64 on the CPU:
    the sharded v4 EM and its replicate batch, against the unsharded
    segment-sum run of the same replicates."""
    import pyarrow.parquet as pq

    argv = ["--alignments", str(small_bam), "--device", "cpu", "--em-dtype",
            "float64", "--num-bootstraps", "2"]
    with caplog.at_level("INFO", logger="oarfish_tpu_torch"):
        assert torch_main(argv + ["-o", str(tmp_path / "v4"), "--em-impl",
                                  "v4", "--num-shards", str(D)]) == 0
    assert f"sharded v4 routing built" in caplog.text
    assert f"over {D} shards" in caplog.text
    assert torch_main(argv + ["-o", str(tmp_path / "seg"), "--em-impl",
                              "segsum"]) == 0
    np.testing.assert_allclose(read_counts(str(tmp_path / "v4") + ".quant"),
                               read_counts(str(tmp_path / "seg") + ".quant"),
                               rtol=1e-9, atol=1e-9)

    def reps(tag):
        t = pq.read_table(str(tmp_path / tag) + ".infreps.pq")
        return np.stack([np.asarray(t[c]) for c in t.column_names])

    np.testing.assert_allclose(reps("v4"), reps("seg"), rtol=1e-9, atol=1e-9)


def test_degenerate_geometry_raises(small_bam, tmp_path, monkeypatch):
    """No feasible route geometry across the shards: the build's error
    reaches the caller with the way out; nothing downgrades to the
    segment-sum sharded EM."""
    def infeasible(mfs, npad):
        raise ValueError("no feasible route geometry at any chunk size")

    monkeypatch.setattr(tsv, "route_config", infeasible)
    with pytest.raises(ValueError, match="--em-impl segsum"):
        torch_main(["--alignments", str(small_bam), "--device", "cpu",
                    "-o", str(tmp_path / "x"), "--em-impl", "v4",
                    "--num-shards", "2"])
    assert not (tmp_path / "x.quant").exists()


@pytest.mark.cuda
def test_sharded_v4_on_the_card_launches_every_shard():
    """Two shards on the card (both on card 0 of one): every m-step of
    every shard launches its kernels, and the counts are the CPU run's
    (f32, the same plans) to rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from oarfish_tpu_torch.utils import trace

    csr = skewed_csr()
    init = np.full(T, R / T)
    sh, mesh = tsv.build_sharded_v4(*csr, T, num_shards=2)
    assert [str(d.device) for d in sh.datas] == ["cuda:0", "cuda:0"]
    counters = ("launch.tile_permute", "launch.route_stage",
                "launch.route_middle", "launch.row_sums")
    before = [trace.counter(c) for c in counters]
    got, n = tsv.make_sharded_v4_runner(mesh, 20)(
        sh, torch.as_tensor(init, device="cuda").float(), CONV)
    torch.cuda.synchronize()
    fused = sh.datas[0].seg_id is not None
    per_step = (2, 2 if fused else 4, int(fused), 1 + int(not fused))
    steps = int(n) + 1
    assert [trace.counter(c) - b for c, b in zip(counters, before)] == [
        2 * k * steps for k in per_step]
    cpu, cpu_mesh = tsv.build_sharded_v4(*csr, T, devices=CPU,
                                         num_shards=2)
    want, wn = tsv.make_sharded_v4_runner(cpu_mesh, 20)(
        cpu, torch.as_tensor(init).float(), CONV)
    assert int(n) == int(wn)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-3)
