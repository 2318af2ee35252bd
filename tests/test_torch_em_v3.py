"""The v3 EM of the torch port (`--em-impl v3`) vs the JAX package's.

One CSR, the smallest at which both permutes route without degenerating:
`random_csr(default_rng(7), R=60_000, T=20_000, max_k=6)`, NPAD 294,912
in 18 chunks, Q 1,280, tiles of R1 = R3 = 640 rows (above 256, so the
offsets the port composes for K2 are int32, as at the bench size on the
card). Each package builds it once per module; the port builds it in f64
and the f32 state differs only in `w_csc`.

Tolerances:

* host tables (`spread_roundrobin`, `balanced_pad_routing`, the
  GlobalPermute tile tables, the sorted-gather plan, `perm1`, `perm2`,
  `src_pos`, `w_csc`, `offsets`, `slot_of_aln`, buckets, read order):
  equal.
* a GlobalPermute on f32 values: the port's plan (K2's plain version)
  gives `x[perm]` and the JAX plan (Pallas interpret mode) bit for bit.
* one f32 m-step against JAX `_m_step_v3`: rtol 1e-5, atol 1e-4. Both
  are about 3e-5 off an f64 m-step on this CSR (the in-tile f32 cumsums,
  which the two packages add in their own orders), and the port is not
  further off it than the JAX package (L1/R each below 2e-6).
* the f64 EM: plain against the NumPy oracle, SQUAREM against the port's
  segment-sum SQUAREM (itself held to the JAX package in
  `test_torch_em.py`), rtol 1e-9; the bulk tail with `--em-impl v3
  --device cpu` against `segsum`, L1/R below 1e-9. Each runs 6 iterations:
  the plain versions of the permutes cost about a quarter second an
  m-step on one CPU thread.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_v3 as jv3
from oarfish_tpu.ops import static_permute as jsp
from oarfish_tpu.ops.em_oracle import do_em_oracle
from oarfish_tpu_torch.config import Args, resolve_filters
from oarfish_tpu_torch.host.filters import DiscardTable
from oarfish_tpu_torch.host.store import AlignmentStore, TranscriptCoverage
from oarfish_tpu_torch.ops import em as tem
from oarfish_tpu_torch.ops import em_v3 as tv3
from oarfish_tpu_torch.ops import sorted_gather as sg
from oarfish_tpu_torch.ops import static_permute as tsp
from oarfish_tpu_torch.quant.bulk import perform_inference_and_write_output
from oarfish_tpu_torch.utils import trace
from test_em import random_csr
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

F64 = torch.float64
R, T = 60_000, 20_000
ITERS = 6


@pytest.fixture(scope="module")
def v3():
    rng = np.random.default_rng(7)
    txp_id, w, boundaries, read_id, _, _ = random_csr(rng, R=R, T=T, max_k=6)
    jd, jorder, jdbg = jv3.EmV3Data.build(txp_id, w, boundaries, T,
                                          debug=True)
    td, torder, tdbg = tv3.EmV3Data.build(txp_id, w, boundaries, T,
                                          dtype=F64, device="cpu", debug=True)
    return dict(csr=(txp_id, w, boundaries, read_id), jd=jd,
                jorder=np.asarray(jorder), jdbg=jdbg, td=td, torder=torder,
                tdbg=tdbg, rng=np.random.default_rng(70))


def f32(td):
    return dataclasses.replace(td, w_csc=td.w_csc.float())


@pytest.mark.parametrize("seed,n,chunk", [(0, 5000, 64), (1, 40_000, 1024),
                                         (2, 1, 64)])
def test_spread_roundrobin_equals_jax(seed, n, chunk):
    vals = np.random.default_rng(seed).choice(200 * chunk, size=n,
                                              replace=False)
    np.testing.assert_array_equal(tsp.spread_roundrobin(vals, chunk),
                                  jsp.spread_roundrobin(vals, chunk))


@pytest.mark.parametrize("seed,cover", [(3, 0.6), (4, 0.95), (5, 1.0)])
def test_balanced_pad_routing_equals_jax(seed, cover):
    rng = np.random.default_rng(seed)
    n_pad, chunk = 16 * 256, 256
    k = int(cover * n_pad)
    out_idx = rng.choice(n_pad, size=k, replace=False)
    # skewed sources: the pads must even the chunk flows out
    in_idx = np.sort(rng.choice(n_pad, size=k, replace=False))
    got = tsp.balanced_pad_routing(out_idx, in_idx, n_pad, chunk)
    np.testing.assert_array_equal(
        got, jsp.balanced_pad_routing(out_idx, in_idx, n_pad, chunk))
    assert np.array_equal(np.sort(got), np.arange(n_pad))
    np.testing.assert_array_equal(got[out_idx], in_idx)


def test_host_tables_equal_jax(v3):
    jdbg, tdbg = v3["jdbg"], v3["tdbg"]
    assert tdbg.keys() == jdbg.keys()
    for k in jdbg:
        np.testing.assert_array_equal(np.asarray(tdbg[k]),
                                      np.asarray(jdbg[k]), err_msg=k)
    np.testing.assert_array_equal(v3["torder"], v3["jorder"])
    jd, td = v3["jd"], v3["td"]
    assert tdbg["NPAD"] == td.npad == 294_912
    for k in ("bucket_shapes", "bucket_starts", "n_slots", "num_reads",
              "num_txps", "g_rows", "g_table_rows", "num_tiles"):
        assert getattr(td, k) == getattr(jd, k), k
    # the K1 plan: base as the port's [n_rows], the rest as they are
    np.testing.assert_array_equal(td.g_base.numpy(),
                                  np.asarray(jd.g_base)[:, 0])
    # lane and use_hi as one byte an element (`sorted_gather.pack_code`)
    assert td.g_code.dtype == torch.uint8
    lane, use_hi = sg.unpack_code(td.g_code)
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jd.g_lane))
    np.testing.assert_array_equal(use_hi.numpy(),
                                  np.asarray(jd.g_hi).astype(np.int64))
    np.testing.assert_array_equal(td.txp_offsets.numpy(),
                                  np.asarray(jd.txp_offsets))
    np.testing.assert_array_equal(td.w_csc.numpy(), jdbg["w_csc"])


@pytest.mark.parametrize("name", ["p1", "p2"])
def test_global_permute_tables_equal_jax(v3, name):
    jp, tpn = getattr(v3["jd"], name), getattr(v3["td"], name)
    for k in ("n_in", "n_out", "n_src", "n_dst", "n_dst_pad", "Q", "R1",
              "R3"):
        assert getattr(tpn, k) == getattr(jp, k), k
    assert (tpn.n_src, tpn.Q, tpn.R1, tpn.R3) == (18, 1280, 640, 640)
    for stage in ("stage1", "stage3"):
        js, ts = getattr(jp, stage), getattr(tpn, stage)
        assert (ts.rows, ts.n_tiles) == (js.rows, js.n_tiles)
        for k in ("r1", "r2", "src", "lane"):
            np.testing.assert_array_equal(
                getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                err_msg=f"{stage}.{k}")
        # tiles above 256 rows: K2 reads int32 composed offsets
        assert ts.stage.off.dtype == torch.int32


@pytest.mark.parametrize("name", ["p1", "p2"])
def test_global_permute_moves_x_perm_bit_for_bit(v3, name):
    perm = v3["tdbg"]["perm1" if name == "p1" else "perm2"]
    plan = getattr(v3["td"], name)
    x = v3["rng"].normal(size=plan.n_in).astype(np.float32)
    before = trace.counter("launch.tile_permute")
    got = plan(torch.from_numpy(x))
    # the plain version on the CPU
    assert trace.counter("launch.tile_permute") == before
    np.testing.assert_array_equal(got.numpy(), x[perm])
    want = np.asarray(getattr(v3["jd"], name)(jnp.asarray(x)))
    assert got.numpy().tobytes() == want.tobytes()
    # f64 passes through unrounded
    x64 = v3["rng"].normal(size=plan.n_in)
    np.testing.assert_array_equal(plan(torch.from_numpy(x64)).numpy(),
                                  x64[perm])


def test_one_f32_m_step_matches_jax(v3):
    jd, td = v3["jd"], v3["td"]
    prev = v3["rng"].random(T).astype(np.float32) * (2 * R / T)
    want = np.asarray(jv3._m_step_v3(jd, jnp.asarray(prev), None))
    got = tv3._m_step_v3(f32(td), torch.from_numpy(prev), None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    exact = tv3._m_step_v3(td, torch.from_numpy(prev).double(), None).numpy()
    l1_port = np.abs(got.numpy() - exact).sum() / R
    l1_jax = np.abs(want - exact).sum() / R
    assert l1_port < 2e-6 and l1_jax < 2e-6, (l1_port, l1_jax)


def test_f64_em_matches_the_oracle(v3):
    txp_id, w, boundaries, _ = v3["csr"]
    td = v3["td"]
    counts, niter = tv3.run_em_v3(td, tem.uniform_init(td, F64), ITERS, 1e-3)
    assert counts.dtype == F64 and int(niter) == ITERS
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=ITERS)
    np.testing.assert_allclose(counts.numpy(), want, rtol=1e-9, atol=1e-9)


def test_f64_squarem_with_multiplicity_matches_segsum(v3):
    """SQUAREM (3 m-steps a cycle) with bootstrap multiplicities, given in
    the relabeled read order, against the segment-sum SQUAREM on the
    original order."""
    txp_id, w, boundaries, read_id = v3["csr"]
    td, order = v3["td"], v3["torder"]
    mult = v3["rng"].multinomial(R, np.full(R, 1 / R)).astype(np.float64)
    run = tv3.make_runner(td, accel="squarem")
    counts, niter = run(tem.uniform_init(td, F64), ITERS, 1e-3,
                        multiplicity=torch.from_numpy(mult[order]))
    ed = tem.EmData.build(txp_id, w, read_id, R, T, dtype=F64, device="cpu")
    want, wn = tem.run_em_squarem(ed, tem.uniform_init(ed, F64), ITERS,
                                  1e-3, multiplicity=torch.from_numpy(mult))
    assert int(niter) == int(wn) == ITERS  # two cycles
    np.testing.assert_allclose(counts.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_toy_csr_is_degenerate():
    rng = np.random.default_rng(1)
    txp_id, w, boundaries, _, _, _ = random_csr(rng, R=300, T=40)
    with pytest.raises(ValueError, match="degenerate"):
        tv3.EmV3Data.build(txp_id, w, boundaries, 40, device="cpu")
    with pytest.raises(ValueError, match="degenerate"):
        jv3.EmV3Data.build(txp_id, w, boundaries, 40)


def store_of(csr):
    txp_id, w, boundaries, _ = csr
    A = len(txp_id)
    return AlignmentStore(
        txp_id=txp_id, start=np.ones(A, dtype=np.int64),
        end=np.full(A, 1000, dtype=np.int64), as_prob=w,
        cov_prob=np.ones(A, dtype=np.float64), boundaries=boundaries,
        discard=DiscardTable(valid_best_aln=R),
        num_unique_alignments=int((np.diff(boundaries) == 1).sum()),
    )


def test_bulk_tail_v3_on_the_cpu_matches_segsum(v3, tmp_path, caplog):
    """`perform_inference_and_write_output` with `--em-impl v3 --device
    cpu` (f64, the plain versions; no `NotImplementedError`) against
    `segsum`; the quant files agree to the L1/R limit."""
    store = store_of(v3["csr"])
    names = [f"t{i}" for i in range(T)]
    lens = np.full(T, 2000, dtype=np.int64)
    out = {}
    for impl in ("v3", "segsum"):
        args = Args(output=tmp_path / impl, em_impl=impl, device="cpu",
                    em_dtype="float64", max_em_iter=ITERS)
        k1 = (trace.counter("launch.sorted_gather"),
              trace.counter("launch.tile_permute"))
        with caplog.at_level("INFO", logger="oarfish_tpu_torch"):
            out[impl] = perform_inference_and_write_output(
                store, TranscriptCoverage(lens, 0), names, lens,
                resolve_filters(args), args, {}, 0.0)
        assert (trace.counter("launch.sorted_gather"),
                trace.counter("launch.tile_permute")) == k1
    assert "v3 routing built" in caplog.text
    assert f"v3 EM on cpu (float64) converged after {ITERS}" in caplog.text
    assert np.abs(out["v3"] - out["segsum"]).sum() / R < 1e-9


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_v3_m_step_on_the_card_launches_k1_and_k2(v3):
    """On the card an m-step is one sorted gather and four tile permutes,
    every one of them bit-equal to its plain version on the same inputs
    (the glue adds in the card's order, so the m-step is held to rtol)."""
    _skip_without_card()
    txp_id, w, boundaries, _ = v3["csr"]
    cd, _ = tv3.EmV3Data.build(txp_id, w, boundaries, T, device="cuda")
    prev = torch.from_numpy(v3["rng"].random(T).astype(np.float32)).cuda()
    k1, k2 = (trace.counter("launch.sorted_gather"),
              trace.counter("launch.tile_permute"))
    got = tv3._m_step_v3(cd, prev, None)
    torch.cuda.synchronize()
    assert (trace.counter("launch.sorted_gather") - k1,
            trace.counter("launch.tile_permute") - k2) == (1, 4)
    want = tv3._m_step_v3(f32(v3["td"]), prev.cpu(), None)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    for name in ("p1", "p2"):
        plan = getattr(cd, name)
        x = torch.randn(plan.n_in, device="cuda")
        assert torch.equal(plan(x).cpu(),
                           getattr(v3["td"], name)(x.cpu()))
    counts, _ = tv3.run_em_v3(cd, tem.uniform_init(cd, torch.float32),
                              200, 1e-3)
    ed = tem.EmData.build(txp_id, w, v3["csr"][3], R, T, dtype=F64,
                          device="cpu")
    ref, _ = tem.run_em(ed, tem.uniform_init(ed, F64), 200, 1e-3)
    assert abs(float(counts.sum()) - R) / R < 1e-5
    assert np.abs(counts.double().cpu().numpy() - ref.numpy()).sum() / R < 2e-3
