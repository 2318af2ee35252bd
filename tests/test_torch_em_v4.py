"""The routed v4 EM of the torch port vs the JAX package's: layouts,
device state and single and batched m-steps. Whole EM runs and the CLI are
in `test_torch_em_v4_runs.py`, on the same CSRs.

Two CSRs at a size where the routing builds with several chunks a side
(R = 40,000 reads, T = 2,000 transcripts): uniform transcript popularity,
and zipf-skewed so that some transcripts are chunked over several rows
(`n_big > 0`). Each is built once per module by both packages. The JAX
side is reached through `EmV4Data.build`, `_m_step_v4` and `make_runner`
directly (its Pallas kernels run in interpret mode on the CPU); its CLI
cannot serve, since on a CPU backend it turns `v4` into `fast`.

Tolerances, all f32:

* layouts, slot maps, route tables, level table, weights: equal.
* one m-step on the JAX package's tables: rtol 1e-6 (atol 1e-6) for the
  uniform CSR. The kernels are bit-equal (`test_torch_static_permute.py`,
  `test_torch_route_middle.py`); the row sums around them add in torch's
  order. For the skewed CSR, whose hot transcripts sum many terms in two
  levels, rtol 1e-5 (atol 1e-5).
* the m-step of a batch of replicates (`_m_step_v4_batch`, one call of each
  kernel's plain version for all replicates): against the JAX package's
  `_m_step_v4_batch` (its in-kernel replicate arm, switched on for the
  test) at rtol 1e-6; against the port's own `_m_step_v4` per replicate,
  equal bit for bit on the CPU (torch sums a bucket's rows in the same
  order with and without the leading axis).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_v4 as jv4
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops import plan_cache
from oarfish_tpu_torch.ops.convert import (
    ROUTE_META,
    V4_META,
    v4_data_from_jax,
)
from oarfish_tpu_torch.ops.static_permute import ROUTE_TABLES
from oarfish_tpu_torch.utils import trace
from test_em import random_csr
from test_torch_static_permute import np_or_none, route_fields, tile_fields
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

R, T = 40_000, 2_000


def carried(jd):
    """The JAX package's device state as the port's, on the CPU."""
    return v4_data_from_jax(
        np.asarray(jd.w_txp), route_fields(jd.p_a), route_fields(jd.p_b),
        tile_fields(jd.t_in), tile_fields(jd.t_out),
        np.asarray(jd.big_row_of_txp), np.asarray(jd.big_row_offsets),
        np_or_none(jd.seg_id), {k: getattr(jd, k) for k in V4_META},
        torch.float32, "cpu",
    )


CASES = {"uniform": 12, "skewed": 11}


def build_case(name):
    """One CSR built by both packages, with the JAX package's state carried
    into the port's."""
    rng = np.random.default_rng(CASES[name])
    txp_id, w, boundaries, _, _, _ = random_csr(rng, R=R, T=T, max_k=4)
    if name == "skewed":
        txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)
    jd, jorder = jv4.EmV4Data.build(txp_id, w, boundaries, T)
    td, torder = tv4.EmV4Data.build(txp_id, w, boundaries, T, device="cpu")
    return dict(rng=rng, csr=(txp_id, w, boundaries), jd=jd,
                jorder=np.asarray(jorder), td=td, torder=torder,
                carried=carried(jd))


@pytest.fixture(scope="module")
def cases():
    return {name: build_case(name) for name in CASES}


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
    before = (trace.counter("launch.tile_permute"),
              trace.counter("launch.route_stage"),
              trace.counter("launch.route_middle"))
    got = tv4._m_step_v4(
        data, ext_space(data, prev),
        None if mult is None else torch.from_numpy(mult))
    # the plain versions ran: nothing was launched
    assert before == (trace.counter("launch.tile_permute"),
                      trace.counter("launch.route_stage"),
                      trace.counter("launch.route_middle"))
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


BATCH = 3


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
    """Three replicates through one batched m-step of each package; the JAX
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


