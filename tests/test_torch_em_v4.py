"""The routed v4 EM of the torch port vs the JAX package's.

Two CSRs at a size where the routing builds (R = 120,000 reads, T = 2,000
transcripts): uniform transcript popularity, and zipf-skewed so that some
transcripts are chunked over several rows (`n_big > 0`). Each is built once
per module by both packages. The JAX side is reached through
`EmV4Data.build`, `_m_step_v4` and `make_runner` directly (its Pallas
kernels run in interpret mode on the CPU); its CLI cannot serve, since on
a CPU backend it turns `v4` into `fast`.

Tolerances, all f32:

* layouts, slot maps, route tables, level table, weights: equal.
* one m-step on the JAX package's tables: rtol 1e-6 (atol 1e-6) for the
  uniform CSR. The kernels are bit-equal (`test_torch_static_permute.py`);
  the row sums around them add in torch's order. For the skewed CSR, whose
  hot transcripts sum ~1e5 terms in two levels, rtol 1e-5 (atol 1e-5).
* the m-step of a batch of replicates (`_m_step_v4_batch`, one call of each
  kernel's plain version for all replicates): against the JAX package's
  `_m_step_v4_batch` (its in-kernel replicate arm, switched on for the
  test) at rtol 1e-6; against the port's own `_m_step_v4` per replicate,
  equal bit for bit on the CPU (torch sums a bucket's rows in the same
  order with and without the leading axis).
* the whole EM: the same number of iterations, counts at rtol 1e-5 /
  atol 1e-3 (the JAX package's own bar for batched vs serial runs);
  against the NumPy f64 oracle L1/R < 2e-3 and total mass within 1e-4.
  The same bar for the batched SQUAREM run against the JAX package's
  `run_em_v4_batch_squarem`. On the card (`cuda`) a batched replicate
  against its serial run: the same iterations, L1/R < 1e-5.
* `.quant` of `--em-impl v4` (f32) against `--em-impl segsum` (f64)
  through the port's CLI: L1 per read < 2e-3, mass within 1e-4.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_v4 as jv4
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.ops import bootstrap as tboot
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops import plan_cache
from oarfish_tpu_torch.ops import route_middle, route_stage, tile_permute
from oarfish_tpu_torch.ops.convert import (
    ROUTE_META,
    V4_META,
    v4_data_from_jax,
)
from oarfish_tpu_torch.ops.em_oracle import do_em_oracle
from oarfish_tpu_torch.ops.static_permute import ROUTE_TABLES
from test_em import random_csr
from test_torch_static_permute import np_or_none, route_fields, tile_fields

R, T = 120_000, 2_000


def carried(jd):
    """The JAX package's device state as the port's, on the CPU."""
    return v4_data_from_jax(
        np.asarray(jd.w_txp), route_fields(jd.p_a), route_fields(jd.p_b),
        tile_fields(jd.t_in), tile_fields(jd.t_out),
        np.asarray(jd.big_row_of_txp), np.asarray(jd.big_row_offsets),
        np_or_none(jd.seg_id), {k: getattr(jd, k) for k in V4_META},
        torch.float32, "cpu",
    )


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, seed in (("uniform", 12), ("skewed", 11)):
        rng = np.random.default_rng(seed)
        txp_id, w, boundaries, _, _, _ = random_csr(rng, R=R, T=T, max_k=4)
        if name == "skewed":
            txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)
        jd, jorder = jv4.EmV4Data.build(txp_id, w, boundaries, T)
        td, torder = tv4.EmV4Data.build(txp_id, w, boundaries, T,
                                        device="cpu")
        out[name] = dict(rng=rng, csr=(txp_id, w, boundaries), jd=jd,
                         jorder=np.asarray(jorder), td=td, torder=torder,
                         carried=carried(jd))
    return out


@pytest.mark.parametrize("name", ["uniform", "skewed"])
def test_layout_equals_jax(cases, name):
    txp_id, w, boundaries = cases[name]["csr"]
    jl = jv4._v4_layout(txp_id, w, boundaries, T)
    tl = tv4._v4_layout(txp_id, w, boundaries, T)
    assert (tl["n_big"] > 0) == (name == "skewed")
    for key, val in tl.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, jl[key], err_msg=key)
        else:
            assert val == jl[key], key


@pytest.mark.parametrize("name", ["uniform", "skewed"])
def test_device_state_equals_jax(cases, name):
    c = cases[name]
    jd, td = c["jd"], c["td"]
    np.testing.assert_array_equal(c["torder"], c["jorder"])
    for route in ("p_a", "p_b"):
        jp, tp_ = getattr(jd, route), getattr(td, route)
        for k in ROUTE_META:
            assert getattr(jp, k) == getattr(tp_, k), (route, k)
        for k in ROUTE_TABLES:
            a, b = getattr(jp, k), getattr(tp_, k)
            assert (a is None) == (b is None), (route, k)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for tile in ("t_in", "t_out"):
        for k in ("r1", "r2", "src", "lane"):
            np.testing.assert_array_equal(
                getattr(getattr(td, tile), k).numpy(),
                np.asarray(getattr(getattr(jd, tile), k)))
    for k in ("w_txp", "seg_id", "big_row_of_txp", "big_row_offsets"):
        np.testing.assert_array_equal(
            getattr(td, k).numpy(), np.asarray(getattr(jd, k)), err_msg=k)
    for k in V4_META:
        assert getattr(td, k) == getattr(jd, k), k
    assert td.seg_id is not None and td.seg_id.dtype == torch.int8
    assert td.w_txp.dtype == torch.float32


def ext_space(data, prev):
    return torch.nn.functional.pad(torch.from_numpy(prev),
                                   (0, data.t_space - T))


M_STEP_TOL = {"uniform": 1e-6, "skewed": 1e-5}


@pytest.mark.parametrize("name", ["uniform", "skewed"])
@pytest.mark.parametrize("with_mult", [False, True])
def test_m_step_fused_matches_jax(cases, name, with_mult, monkeypatch):
    c = cases[name]
    monkeypatch.delenv("OARFISH_V4_NO_MIDDLE", raising=False)
    rng = np.random.default_rng(3)
    prev = rng.uniform(0.5, 2.0, size=T).astype(np.float32)
    mult = None
    if with_mult:
        mult = rng.multinomial(R, np.full(R, 1.0 / R))[c["jorder"]].astype(
            np.float32)
    want = np.asarray(jv4._m_step_v4(
        c["jd"], jnp.asarray(prev),
        None if mult is None else jnp.asarray(mult)))
    data = c["carried"]
    before = (tile_permute.launch_count, route_stage.launch_count,
              route_middle.launch_count)
    got = tv4._m_step_v4(
        data, ext_space(data, prev),
        None if mult is None else torch.from_numpy(mult))
    # the plain versions ran: nothing was launched
    assert before == (tile_permute.launch_count, route_stage.launch_count,
                      route_middle.launch_count)
    assert got.shape == (data.t_space,) and not got[T:].any()
    tol = M_STEP_TOL[name]
    np.testing.assert_allclose(got[:T].numpy(), want, rtol=tol, atol=tol)
    # the port's own build holds the same tables: the same bits
    own = tv4._m_step_v4(
        c["td"], ext_space(data, prev),
        None if mult is None else torch.from_numpy(mult))
    assert torch.equal(own, got)


@pytest.mark.parametrize("with_mult", [False, True])
def test_m_step_unfused_matches_jax(cases, with_mult, monkeypatch):
    """The branch of a layout with a read bucket wider than a route chunk,
    reached directly; the JAX package reaches it by its switch."""
    c = cases["uniform"]
    rng = np.random.default_rng(4)
    prev = rng.uniform(0.5, 2.0, size=T).astype(np.float32)
    mult = None
    if with_mult:
        mult = rng.multinomial(R, np.full(R, 1.0 / R))[c["jorder"]].astype(
            np.float32)
    monkeypatch.setenv("OARFISH_V4_NO_MIDDLE", "1")
    want = np.asarray(jv4._m_step_v4(
        c["jd"], jnp.asarray(prev),
        None if mult is None else jnp.asarray(mult)))
    data = c["carried"]
    slots = tv4._prev_slots(data, ext_space(data, prev))
    got = tv4._txp_tail(data, tv4._middle_unfused(
        data, slots, None if mult is None else torch.from_numpy(mult)))
    np.testing.assert_allclose(got[:T].numpy(), want, rtol=1e-6, atol=1e-6)
    # and through `_m_step_v4` itself on a state without a level table
    import dataclasses

    no_lvl = dataclasses.replace(data, seg_id=None)
    again = tv4._m_step_v4(
        no_lvl, ext_space(data, prev),
        None if mult is None else torch.from_numpy(mult))
    assert torch.equal(again, got)


def test_both_exchanges_give_the_same_bits(cases):
    """The strided exchange (Q a whole number of lane tiles) and the
    transposed one move the same values."""
    data = cases["uniform"]["td"]
    assert data.p_a.Q % 128 == 0
    rng = np.random.default_rng(5)
    prev = rng.uniform(0.5, 2.0, size=T).astype(np.float32)
    mult = tv4.mult_slots(data, torch.from_numpy(
        rng.integers(0, 4, size=data.row_space_r).astype(np.float32)))
    slots = tv4._prev_slots(data, ext_space(data, prev))
    for m in (None, mult):
        a = tv4._middle_fused(data, slots, m, strided=True)
        b = tv4._middle_fused(data, slots, m, strided=False)
        assert torch.equal(a, b)


BATCH = 6


def batch_inputs(c, with_mult, seed=21):
    rng = np.random.default_rng(seed)
    prev = np.abs(rng.normal(10.0, 3.0, size=(BATCH, T))).astype(np.float32)
    mult = None
    if with_mult:
        mult = rng.multinomial(R, np.full(R, 1.0 / R), size=BATCH)[
            :, c["jorder"]].astype(np.float32)
    return prev, mult


def ext_space_batch(data, prev_b):
    return torch.nn.functional.pad(torch.from_numpy(prev_b),
                                   (0, data.t_space - T))


@pytest.mark.parametrize("name", ["uniform", "skewed"])
@pytest.mark.parametrize("with_mult", [False, True])
def test_m_step_batch_matches_jax(cases, name, with_mult, monkeypatch):
    """Six replicates through one batched m-step of each package; the JAX
    package's in-kernel replicate arm is behind its switch."""
    c = cases[name]
    monkeypatch.setenv("OARFISH_V4_BATCH_KERNELS", "1")
    monkeypatch.delenv("OARFISH_V4_NO_MIDDLE", raising=False)
    monkeypatch.delenv("OARFISH_V4_NO_STRIDED", raising=False)
    assert jv4._batch_eligible(c["jd"])
    data = c["carried"]
    assert tv4._batch_eligible(data)
    prev, mult = batch_inputs(c, with_mult)
    want = np.asarray(jv4._m_step_v4_batch(
        c["jd"], jnp.asarray(prev),
        None if mult is None else jnp.asarray(mult)))
    tmult = None if mult is None else torch.from_numpy(mult)
    got = tv4._m_step_v4_batch(data, ext_space_batch(data, prev), tmult)
    assert got.shape == (BATCH, data.t_space) and not got[:, T:].any()
    tol = M_STEP_TOL[name]
    np.testing.assert_allclose(got[:, :T].numpy(), want, rtol=tol, atol=tol)
    # the multiplicities already in the slot layout: the same bits
    if tmult is not None:
        again = tv4._m_step_v4_batch(
            data, ext_space_batch(data, prev),
            mult_sl_b=tv4.mult_slots(data, tmult))
        assert torch.equal(again, got)


@pytest.mark.parametrize("name", ["uniform", "skewed"])
@pytest.mark.parametrize("with_mult", [False, True])
def test_m_step_batch_equals_per_replicate_steps(cases, name, with_mult):
    """Replicate b of the batched m-step is `_m_step_v4` on replicate b,
    bit for bit, through `make_m_step` as the EM loop calls it."""
    c = cases[name]
    data = c["td"]
    prev, mult = batch_inputs(c, with_mult, seed=22)
    tmult = None if mult is None else torch.from_numpy(mult)
    ext = ext_space_batch(data, prev)
    got = tv4.make_m_step(data, tmult)(ext)
    assert got.shape == (BATCH, data.t_space)
    for b in range(BATCH):
        want = tv4._m_step_v4(data, ext[b],
                              None if tmult is None else tmult[b])
        assert torch.equal(got[b], want), b


def count_calls(monkeypatch):
    """Calls of the three wrappers, as `em_v4` and `static_permute` reach
    them."""
    from oarfish_tpu_torch.ops import static_permute as tsp

    calls = {"tile_permute": 0, "route_stage": 0, "route_middle": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tsp, "tile_permute",
                        counted("tile_permute", tsp.tile_permute))
    monkeypatch.setattr(tsp, "route_stage",
                        counted("route_stage", tsp.route_stage))
    monkeypatch.setattr(tv4, "route_middle",
                        counted("route_middle", tv4.route_middle))
    return calls


def test_batched_m_step_is_one_call_per_kernel(cases, monkeypatch):
    """One call of each wrapper for all replicates: two tile permutes, two
    route stages, one fused middle, as for a single m-step."""
    c = cases["uniform"]
    data = c["td"]
    prev, mult = batch_inputs(c, True)
    step = tv4.make_m_step(data, torch.from_numpy(mult))
    calls = count_calls(monkeypatch)
    step(ext_space_batch(data, prev))
    assert calls == {"tile_permute": 2, "route_stage": 2, "route_middle": 1}


@pytest.mark.parametrize("layout", ["unfused", "transposed"])
def test_ineligible_layout_takes_the_loop(cases, layout, monkeypatch, caplog):
    """Without the level table (unfused middle) or with a quota that is no
    whole number of lane tiles (transposed exchange) the replicates of a
    batch run one after another and give the numbers of single runs; the
    first such m-step says so in the log."""
    import dataclasses

    c = cases["uniform"]
    data = c["td"]
    if layout == "unfused":
        other = dataclasses.replace(data, seg_id=None)
        per_step = {"tile_permute": 2, "route_stage": 4, "route_middle": 0}
    else:
        # the same tables, read through the transposed exchange
        monkeypatch.setattr(tv4, "_batch_eligible", lambda d: False)
        monkeypatch.setattr(
            tv4, "_middle_fused",
            lambda d, p, m, _f=tv4._middle_fused: _f(d, p, m, strided=False))
        other = data
        per_step = {"tile_permute": 2, "route_stage": 2, "route_middle": 1}
    assert not tv4._batch_eligible(other)
    prev, mult = batch_inputs(c, True, seed=23)
    tmult = torch.from_numpy(mult)
    ext = ext_space_batch(data, prev)
    monkeypatch.setattr(tv4, "_loop_logged", False)
    calls = count_calls(monkeypatch)
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        step = tv4.make_m_step(other, tmult)
        got = step(ext)
        step(ext)
    assert calls == {k: 2 * BATCH * n for k, n in per_step.items()}
    assert caplog.text.count("replicates of a batch run one after another") == 1
    for b in range(BATCH):
        want = tv4._m_step_v4(other, ext[b], tmult[b])
        assert torch.equal(got[b], want)
    # and the loop gives what the one program gives, to the glue's rounding
    batched = tv4._m_step_v4_batch(data, ext, tmult)
    np.testing.assert_allclose(got.numpy(), batched.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_batched_em_matches_jax_batch_runner(cases, monkeypatch):
    """`run_em_v4` on `[B, T]` against the JAX package's `run_em_v4_batch`
    with its in-kernel arm: the same iterations per replicate."""
    c = cases["uniform"]
    monkeypatch.setenv("OARFISH_V4_BATCH_KERNELS", "1")
    rng = np.random.default_rng(16)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, c["torder"]].astype(
        np.float32)
    jax_counts, jax_niter = jv4.run_em_v4_batch(
        c["jd"], jnp.full(T, R / T, dtype=jnp.float32), 56, 5e-3,
        jnp.asarray(mult))
    init = torch.full((3, T), R / T, dtype=torch.float32)
    counts, niter = tv4.run_em_v4(c["td"], init, 56, 5e-3,
                                  multiplicity=torch.from_numpy(mult))
    assert niter.tolist() == np.asarray(jax_niter).tolist()
    np.testing.assert_allclose(counts.numpy(), np.asarray(jax_counts),
                               rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def em_runs(cases):
    c = cases["uniform"]
    init = torch.full((T,), R / T, dtype=torch.float32)
    counts, niter = tv4.run_em_v4(c["td"], init, 60, 5e-3)
    return c, init, counts, int(niter)


def test_em_matches_jax_runner(em_runs):
    c, _, counts, niter = em_runs
    runner = jv4.make_runner(c["jd"])
    want, jniter = runner(jnp.full(T, R / T, dtype=jnp.float32), 60, 5e-3)
    assert niter == int(jniter) and 50 < niter < 60
    np.testing.assert_allclose(counts.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)


def test_em_matches_numpy_oracle(em_runs):
    """15 iterations of both (the f64 oracle is a serial NumPy loop)."""
    c, init, _, _ = em_runs
    txp_id, w, boundaries = c["csr"]
    counts, niter = tv4.run_em_v4(c["td"], init, 15, 5e-3)
    assert int(niter) == 15
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=15,
                        convergence_thresh=5e-3)
    got = counts.double().numpy()
    assert abs(got.sum() - R) / R < 1e-4
    assert np.abs(got - want).sum() / R < 2e-3


def test_second_run_is_bit_identical(em_runs):
    c, init, counts, niter = em_runs
    again, n2 = tv4.run_em_v4(c["td"], init, 60, 5e-3)
    assert int(n2) == niter and torch.equal(again, counts)


def test_squarem_reaches_the_same_fixed_point(em_runs):
    c, init, counts, _ = em_runs
    sq, n = tv4.run_em_v4_squarem(c["td"], init, 60, 5e-3)
    assert int(n) <= 60
    assert abs(float(sq.double().sum()) - R) / R < 1e-4
    assert float((sq - counts).abs().sum()) / R < 5e-3


def test_bootstraps_equal_serial_runs(cases):
    """`run_replicates` over the batched loop equals one run per
    replicate, each with its own iteration count."""
    c = cases["uniform"]
    data = c["td"]
    init = torch.full((T,), R / T, dtype=torch.float32)
    rng = np.random.default_rng(15)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, c["torder"]]
    assert mult.shape == (3, data.row_space_r)
    got, niters = tboot.run_replicates(
        lambda i, m: tv4.run_em_v4(data, i, 56, 5e-3, multiplicity=m),
        mult, init, batch=2,
    )
    assert got.shape == (3, T)
    for b in range(3):
        want, niter = tv4.run_em_v4(
            data, init, 56, 5e-3,
            multiplicity=torch.from_numpy(mult[b]).float())
        assert int(niter) == int(niters[b])
        np.testing.assert_array_equal(got[b], want.double().numpy())
        assert abs(got[b].sum() - R) / R < 1e-4


@pytest.mark.cuda
def test_batched_replicates_on_the_card_match_serial_runs(cases):
    """On the card the kernels give every replicate of a batch the bits of
    a single launch, but torch's CUDA `sum` splits a reduction by its
    number of outputs, so the batched glue adds a bucket's rows in another
    order than a single m-step and a replicate's last bits depend on its
    batch. Held here: the same iterations as the serial run, and counts
    within L1 / R < 1e-5 of it (f32, up to 200 iterations), whatever the
    batch (3 at once, or 2 and 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = cases["uniform"]
    txp_id, w, boundaries = c["csr"]
    data, order = tv4.EmV4Data.build(txp_id, w, boundaries, T, device="cuda")
    np.testing.assert_array_equal(order, c["torder"])
    init = torch.full((T,), R / T, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(19)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, order]

    def run(i, m):
        return tv4.run_em_v4(data, i, 200, 1e-3, multiplicity=m)

    serial = [run(init, torch.from_numpy(mult[b]).float().cuda())
              for b in range(3)]
    for batch in (3, 2):
        got, niters = tboot.run_replicates(run, mult, init, batch=batch)
        for b, (want, niter) in enumerate(serial):
            assert int(niters[b]) == int(niter) > 50, (batch, b)
            l1 = np.abs(got[b] - want.double().cpu().numpy()).sum() / R
            assert l1 < 1e-5, (batch, b, l1)
            assert abs(got[b].sum() - R) / R < 1e-4


def test_squarem_batch_equals_serial_runs(cases):
    """`run_em_v4_squarem` on `[B, T]` (the counterpart of
    `run_em_v4_batch_squarem`) against one accelerated run per replicate:
    the same iterations; values at rtol 1e-5 (the step length is a ratio of
    two dot products over T, which a batch sums in another order, and it
    reaches 64)."""
    c = cases["uniform"]
    data = c["td"]
    rng = np.random.default_rng(17)
    mult = torch.from_numpy(tboot.sample_multiplicities(rng, 2, R)[
        :, c["torder"]].astype(np.float32))
    init = torch.full((2, T), R / T, dtype=torch.float32)
    got, niters = tv4.run_em_v4_squarem(data, init, 30, 5e-3,
                                        multiplicity=mult)
    assert got.shape == (2, T)
    for b in range(2):
        want, niter = tv4.run_em_v4_squarem(data, init[b], 30, 5e-3,
                                            multiplicity=mult[b])
        assert int(niter) == int(niters[b]) == 30
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-3)
        assert abs(float(got[b].double().sum()) - R) / R < 1e-4


def test_squarem_batch_matches_jax_batch_runner(cases, monkeypatch):
    """`run_em_v4_squarem` on `[B, T]` against the JAX package's
    `run_em_v4_batch_squarem` with its in-kernel arm, on the carried
    tables: the same iterations per replicate, counts at the whole EM's
    rtol 1e-5 / atol 1e-3."""
    c = cases["uniform"]
    monkeypatch.setenv("OARFISH_V4_BATCH_KERNELS", "1")
    rng = np.random.default_rng(18)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, c["jorder"]].astype(
        np.float32)
    jax_counts, jax_niter = jv4.run_em_v4_batch_squarem(
        c["jd"], jnp.full(T, R / T, dtype=jnp.float32), 30, 5e-3,
        jnp.asarray(mult))
    init = torch.full((3, T), R / T, dtype=torch.float32)
    counts, niter = tv4.run_em_v4_squarem(
        c["carried"], init, 30, 5e-3, multiplicity=torch.from_numpy(mult))
    assert niter.tolist() == np.asarray(jax_niter).tolist()
    got = counts.numpy()
    assert got.shape == (3, T)
    np.testing.assert_allclose(got, np.asarray(jax_counts)[:, :T],
                               rtol=1e-5, atol=1e-3)
    assert (np.abs(got.astype(np.float64).sum(axis=1) - R) / R < 1e-4).all()


def test_plan_cache_round_trip(cases, tmp_path, monkeypatch, caplog):
    c = cases["uniform"]
    txp_id, w, boundaries = c["csr"]
    monkeypatch.setenv("OARFISH_PLAN_CACHE", "1")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    assert plan_cache.cache_dir() == tmp_path / "plans"
    first, order1 = tv4.EmV4Data.build(txp_id, w, boundaries, T, device="cpu")
    plan_cache.wait_for_stores()
    entries = list((tmp_path / "plans").glob("*.plan"))
    assert len(entries) == 1
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        # other weights: the plan depends on the structure alone
        second, order2 = tv4.EmV4Data.build(txp_id, w * 2.0, boundaries, T,
                                            device="cpu")
    assert "plan cache hit" in caplog.text
    np.testing.assert_array_equal(order1, order2)
    assert torch.equal(second.w_txp, first.w_txp * 2.0)
    for route in ("p_a", "p_b"):
        for k in ROUTE_TABLES:
            a, b = getattr(getattr(first, route), k), getattr(
                getattr(second, route), k)
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    third, _ = tv4.EmV4Data.build(txp_id, w, boundaries, T, device="cpu")
    init = torch.full((T,), R / T, dtype=torch.float32)
    a, na = tv4.run_em_v4(first, init, 5, 5e-3)
    b, nb = tv4.run_em_v4(third, init, 5, 5e-3)
    assert int(na) == int(nb) and torch.equal(a, b)
    # the default directory is this package's own
    monkeypatch.delenv("OARFISH_PLAN_CACHE_DIR")
    assert plan_cache.cache_dir().parts[-2:] == ("oarfish_tpu_torch", "plans")


def test_infeasible_geometry_raises_and_names_the_way_out(tmp_path,
                                                          monkeypatch):
    """A tiny input still routes (one chunk a side). Where no route
    geometry is feasible the build's error reaches the caller with a
    message that names `--em-impl pallas`: no change of formulation behind
    the caller's back. Layout balancing keeps small inputs feasible, so the
    build's own error is raised in its place here."""
    from util_sim import simulate_bam

    bam = tmp_path / "small.bam"
    simulate_bam(bam, num_reads=300, seed=5,
                 names=[f"t{i}" for i in range(9)],
                 lengths=[900 + 150 * i for i in range(9)])
    argv = ["--alignments", str(bam), "--quiet", "--device", "cpu"]
    assert torch_main(argv + ["--em-impl", "v4", "-o",
                              str(tmp_path / "v4")]) == 0
    assert torch_main(argv + ["--em-impl", "segsum", "--em-dtype", "float32",
                              "-o", str(tmp_path / "seg")]) == 0
    np.testing.assert_allclose(
        read_counts(str(tmp_path / "v4") + ".quant"),
        read_counts(str(tmp_path / "seg") + ".quant"), rtol=1e-3, atol=1e-2)

    def infeasible(mfs, npad):
        raise ValueError("no feasible route geometry at any chunk size")

    monkeypatch.setattr(tv4, "route_config", infeasible)
    with pytest.raises(ValueError, match="--em-impl pallas"):
        torch_main(argv + ["--em-impl", "v4", "-o", str(tmp_path / "x")])


def read_counts(path):
    with open(path) as fh:
        return np.array([float(ln.split("\t")[2]) for ln in fh.readlines()[1:]])


def test_cli_v4_matches_segsum(tmp_path, caplog):
    """A BAM of the same size through the port's CLI on the CPU."""
    from chip_smoke import build_e2e_bam

    bam = tmp_path / "v4.bam"
    build_e2e_bam(bam, R, T, seed=3, threads=2)
    base = ["--alignments", str(bam), "--device", "cpu", "--num-bootstraps",
            "2", "--seed", "1"]
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        assert torch_main(base + ["--em-impl", "v4", "-o",
                                  str(tmp_path / "v4")]) == 0
    assert "v4 EM on cpu (float32)" in caplog.text
    assert "--em-impl v4 runs in float32" in caplog.text
    assert torch_main(base + ["--em-impl", "segsum", "--quiet", "-o",
                              str(tmp_path / "seg")]) == 0
    got = read_counts(str(tmp_path / "v4") + ".quant")
    want = read_counts(str(tmp_path / "seg") + ".quant")
    kept = want.sum()
    assert got.shape == (T,) and kept > 0.9 * R
    assert abs(got.sum() - kept) / kept < 1e-4
    assert np.abs(got - want).sum() / kept < 2e-3
    import pyarrow.parquet as pq

    reps = [pq.read_table(str(tmp_path / tag) + ".infreps.pq")
            for tag in ("v4", "seg")]
    a, b = (np.stack([np.asarray(t[c]) for c in t.column_names])
            for t in reps)
    assert a.shape == b.shape == (2, T)
    # the same draw reaches the same reads through the layout's row order
    assert np.abs(a - b).sum(axis=1).max() / kept < 2e-3
