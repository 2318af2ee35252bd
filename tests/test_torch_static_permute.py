"""Tile permute and route stage of the torch port vs the Pallas kernels
of the JAX package.

The same seeded NumPy inputs and the same int8 tables (built by the JAX
package and carried across by `ops/convert.py`) go through
`static_permute._run_batch` and `_run_route_stage` (Pallas interpret mode
on the CPU) and through the port's plain versions, which are what the port
runs for CPU tensors and what the CUDA kernels are held against on the
card. The fused middle has its own file, `test_torch_route_middle.py`;
here it meets only a quota of half a lane tile.

The replicate axis (`B > 0` in the JAX kernels, a leading axis here) goes
through `_run_route_stage(..., B=B)` and the port's plain versions with B
in {1, 3}, and each replicate must also equal what a call without the axis
gives.

The source offsets that the port's plans compose from the tables (what the
CUDA kernels of K2 and K3 read) are held to the same outputs through a
plain torch gather, `through_offsets`, which does the kernels' index
arithmetic: -1 gives 0, the quota view's rows split by the multiply-high of
`route_stage.q_inverse`.

Tolerance: none. K2 and K3 move f32 values (K3 with one product per
element when `mul` is given). All outputs must be equal bit for bit,
uncovered quota slots included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.constants import EM_DENOM_THRESH
from oarfish_tpu.ops import static_permute as jsp
from oarfish_tpu_torch.ops import route_middle as rm
from oarfish_tpu_torch.ops import route_stage as rs
from oarfish_tpu_torch.ops import static_permute as tsp
from oarfish_tpu_torch.ops import tile_permute as tp
from oarfish_tpu_torch.ops.convert import (
    ROUTE_META,
    route_plan_from_numpy,
    tile_permute_from_numpy,
)
from oarfish_tpu_torch.utils import trace
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

LANES = 128


def np_or_none(a):
    return None if a is None else np.asarray(a)


def route_fields(jplan):
    """A JAX `GlobalRoutePlan` as `convert.route_plan_from_numpy` takes it."""
    fields = {k: np_or_none(getattr(jplan, k)) for k in tsp.ROUTE_TABLES}
    fields.update({k: getattr(jplan, k) for k in ROUTE_META})
    return fields


def tile_fields(jtile):
    """A JAX `BatchTilePermute` as `convert.tile_permute_from_numpy` takes
    it."""
    return ({k: np.asarray(getattr(jtile, k))
             for k in ("r1", "r2", "src", "lane")}
            | {"rows": jtile.rows, "n_tiles": jtile.n_tiles})


def route_to_port(jplan):
    return route_plan_from_numpy(route_fields(jplan), "cpu")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def through_offsets(x, stage, mul=None):
    """The stage as its CUDA kernels compute it, in plain torch: values of
    either layout (behind a replicate axis or not) gathered through
    `stage.off`, 0 where an offset is -1."""
    B = x.shape[0] if x.dim() in (3, 5) else 0
    Q = x.shape[-2] * LANES if x.dim() >= 4 else 0
    off = stage.off.long().reshape(stage.n_chunks, -1)
    j = torch.arange(stage.n_chunks).reshape(-1, 1)
    e = off.clamp(min=0)
    tile_after_tile = j * stage.R_in * LANES + e
    if Q:
        s = ((e >> 7) * rs.q_inverse(Q)) >> 32
        src = (s * stage.n_chunks + j) * Q + (e - s * Q)
    else:
        src = tile_after_tile
    v = x.reshape(max(B, 1), -1)[:, src.reshape(-1)]
    if mul is not None:
        v = v * mul.reshape(-1)[tile_after_tile.reshape(-1)]
    v = torch.where(off.reshape(-1) < 0, torch.zeros_like(v), v)
    return v.reshape(*x.shape[:1 if B else 0], -1, LANES)


def random_route(seed, n_chunks, chunk_rows, cover=0.8):
    rng = np.random.default_rng(seed)
    n = n_chunks * chunk_rows * LANES
    n_data = int(n * cover)
    out_idx = np.sort(rng.choice(n, size=n_data, replace=False))
    in_idx = rng.permutation(n)[:n_data]
    return rng, n, out_idx, in_idx


def level_table(rng, n_chunks, cr, max_lvl):
    """[n_chunks * cr, 128] i8 as `em_v4._read_lvl_ids` lays it out: runs
    of aligned groups of 2^L rows, every L in 0..max_lvl present in every
    chunk, -1 rows between them."""
    lvl = np.full(n_chunks * cr, -1, dtype=np.int8)
    for c in range(n_chunks):
        r = 0
        # largest first, so that every mandatory group is aligned
        todo = [-1] + list(range(max_lvl + 1))
        while r < cr:
            L = todo.pop() if todo else int(rng.integers(-1, max_lvl + 1))
            K = 1 << max(L, 0)
            r = -(-r // K) * K  # align
            if r + K > cr:
                break
            lvl[c * cr + r: c * cr + r + K] = L
            r += K
    return np.ascontiguousarray(np.broadcast_to(lvl[:, None],
                                                (n_chunks * cr, LANES)))


# ---------------------------------------------------------------------------
# K2: batched tile permute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rows,n_tiles", [(0, 128, 1), (1, 256, 3),
                                               (2, 512, 2)])
def test_tile_permute_bit_equal_to_pallas(seed, rows, n_tiles):
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(rows * LANES) for _ in range(n_tiles)]
    jb = jsp.BatchTilePermute.build(
        [jsp.DeviceTilePlan.build(p, rows) for p in perms])
    x = rng.normal(size=n_tiles * rows * LANES).astype(np.float32)
    want = np.asarray(jb(jnp.asarray(x)))
    carried = tile_permute_from_numpy(tile_fields(jb), "cpu")
    own = tsp.BatchTilePermute.build(
        [tsp.DeviceTilePlan.build(p, rows) for p in perms], device="cpu")
    for plan in (carried, own):
        got = plan(torch.from_numpy(x))
        assert got.dtype == torch.float32
        assert bits(got.numpy()) == bits(want)
        # the composed offsets: a permutation, nothing is -1
        assert plan.stage.off.dtype == rs.offset_dtype(rows)
        assert bits(through_offsets(torch.from_numpy(x), plan.stage)) == bits(want)
    np.testing.assert_array_equal(
        want, np.concatenate([x[i * rows * LANES:(i + 1) * rows * LANES][p]
                              for i, p in enumerate(perms)]))
    for name in ("r1", "r2", "src", "lane"):
        np.testing.assert_array_equal(
            getattr(own, name).numpy(), np.asarray(getattr(jb, name)))


def test_tile_permute_f64_passes_through():
    rng = np.random.default_rng(7)
    perm = rng.permutation(256 * LANES)
    plan = tsp.BatchTilePermute.build(
        [tsp.DeviceTilePlan.build(perm, 256)], device="cpu")
    x = rng.normal(size=256 * LANES)
    got = plan(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), x[perm])


@pytest.mark.parametrize("B", [1, 3])
def test_tile_permute_replicates_share_the_tables(B):
    """`[B, n]` is B times the tiles through the same tables, in one call;
    the JAX package gets the same by calling its kernel per replicate."""
    rng = np.random.default_rng(8)
    rows, n_tiles = 256, 2
    perms = [rng.permutation(rows * LANES) for _ in range(n_tiles)]
    jb = jsp.BatchTilePermute.build(
        [jsp.DeviceTilePlan.build(p, rows) for p in perms])
    plan = tile_permute_from_numpy(tile_fields(jb), "cpu")
    x = rng.normal(size=(B, n_tiles * rows * LANES)).astype(np.float32)
    got = plan(torch.from_numpy(x))
    assert got.shape == x.shape
    by_offsets = through_offsets(
        torch.from_numpy(x).reshape(B, -1, LANES), plan.stage)
    for b in range(B):
        assert bits(got[b].numpy()) == bits(jb(jnp.asarray(x[b])))
        assert torch.equal(got[b], plan(torch.from_numpy(x[b])))
        assert bits(by_offsets[b]) == bits(got[b])


# ---------------------------------------------------------------------------
# K3: one route stage
# ---------------------------------------------------------------------------

# seed, chunks, chunk rows: 128 rows is one input block in the expand stage
# (no `src` table), 256 and 512 are several
ROUTES = [(13, 16, 128), (14, 12, 256), (15, 4, 512)]


@pytest.fixture(scope="module")
def routes():
    out = {}
    for seed, n_chunks, cr in ROUTES:
        rng, n, out_idx, in_idx = random_route(seed, n_chunks, cr)
        jr = jsp.GlobalRoute(out_idx, in_idx, n, chunk_rows=cr)
        out[cr] = (rng, n, out_idx, in_idx, jr.plan, route_to_port(jr.plan))
    return out


@pytest.mark.parametrize("cr", [r[2] for r in ROUTES])
@pytest.mark.parametrize("with_mul", [False, True])
def test_expand_stage_bit_equal_to_pallas(routes, cr, with_mul):
    rng, n, _, _, jp, tpn = routes[cr]
    assert (tpn.s1_src is None) == (cr == 128)
    x = rng.normal(size=n).astype(np.float32)
    mul = rng.normal(size=n).astype(np.float32) if with_mul else None
    want = np.asarray(jp.expand_y1(
        jnp.asarray(x), None if mul is None else jnp.asarray(mul)))
    tmul = None if mul is None else torch.from_numpy(mul)
    got = tpn.expand_y1(torch.from_numpy(x), tmul)
    assert got.shape == (tpn.n_src * tpn.R1, LANES)
    assert bits(got.numpy()) == bits(want)
    by_offsets = through_offsets(
        tpn._pad(torch.from_numpy(x)).reshape(-1, LANES), tpn.expand_stage,
        None if tmul is None else tpn._pad(tmul).reshape(-1, LANES))
    assert bits(by_offsets) == bits(want)


@pytest.mark.parametrize("cr", [r[2] for r in ROUTES])
@pytest.mark.parametrize("strided", [False, True])
def test_reduce_stage_bit_equal_to_pallas(routes, cr, strided):
    """The masked reduce stage on a full quota tensor of random values
    (uncovered slots included), through the transposed exchange and
    through the strided one."""
    rng, _, _, _, jp, tpn = routes[cr]
    assert tpn.Q % LANES == 0, "the strided exchange needs whole lane tiles"
    y1 = rng.normal(size=(tpn.n_src * tpn.R1, LANES)).astype(np.float32)
    if strided:
        want = np.asarray(jp.reduce_strided(jnp.asarray(y1), sliced=False))
        got = tpn.reduce_strided(torch.from_numpy(y1), sliced=False)
        values = tpn.quota_view(torch.from_numpy(y1))
    else:
        zg = y1.reshape(tpn.n_src, tpn.n_dst, tpn.Q).transpose(1, 0, 2)
        zg = np.ascontiguousarray(zg).reshape(tpn.n_dst * tpn.R3, LANES)
        want = np.asarray(jp.reduce(jnp.asarray(zg), sliced=False))
        got = tpn.reduce(torch.from_numpy(zg), sliced=False)
        values = torch.from_numpy(zg)
    assert bits(got.numpy()) == bits(want)
    assert bits(through_offsets(values, tpn.reduce_stage)) == bits(want)
    # masked outputs are exactly zero
    mask = tpn.s3_mask.numpy().reshape(-1) != 0
    assert not got.numpy()[~mask].any()


REPLICATES = [1, 3]


@pytest.mark.parametrize("B", REPLICATES)
@pytest.mark.parametrize("cr", [r[2] for r in ROUTES])
@pytest.mark.parametrize("with_mul", [False, True])
def test_expand_stage_replicates_bit_equal_to_pallas(routes, cr, with_mul, B):
    """`expand_y1_batch`: values with a leading replicate axis, `mul`
    shared; H_in = 1 (128 rows) and > 1."""
    rng, n, _, _, jp, tpn = routes[cr]
    x = rng.normal(size=(B, n)).astype(np.float32)
    mul = rng.normal(size=n).astype(np.float32) if with_mul else None
    want = np.asarray(jp.expand_y1_batch(
        jnp.asarray(x), None if mul is None else jnp.asarray(mul)))
    tmul = None if mul is None else torch.from_numpy(mul)
    got = tpn.expand_y1_batch(torch.from_numpy(x), tmul)
    assert got.shape == (B, tpn.n_src * tpn.R1, LANES)
    assert bits(got.numpy()) == bits(want)
    by_offsets = through_offsets(
        tpn._pad(torch.from_numpy(x)).reshape(B, -1, LANES), tpn.expand_stage,
        None if tmul is None else tpn._pad(tmul).reshape(-1, LANES))
    assert bits(by_offsets) == bits(want)
    for b in range(B):
        assert torch.equal(got[b], tpn.expand_y1(torch.from_numpy(x[b]), tmul))


@pytest.mark.parametrize("B", REPLICATES)
@pytest.mark.parametrize("cr", [r[2] for r in ROUTES])
@pytest.mark.parametrize("strided", [False, True])
def test_reduce_stage_replicates_bit_equal_to_pallas(routes, cr, strided, B):
    """The masked reduce stage with a replicate axis: on the quota view
    (`reduce_strided_batch`) and on tile-after-tile values."""
    rng, _, _, _, jp, tpn = routes[cr]
    y1 = rng.normal(size=(B, tpn.n_src * tpn.R1, LANES)).astype(np.float32)
    if strided:
        want = np.asarray(jp.reduce_strided_batch(jnp.asarray(y1),
                                                  sliced=False))
        got = tpn.reduce_strided_batch(torch.from_numpy(y1), sliced=False)
        values = tpn.quota_view(torch.from_numpy(y1))
        single = [tpn.reduce_strided(torch.from_numpy(y1[b]), sliced=False)
                  for b in range(B)]
    else:
        zg = y1.reshape(B, tpn.n_src, tpn.n_dst, tpn.Q).transpose(0, 2, 1, 3)
        zg = np.ascontiguousarray(zg).reshape(B, tpn.n_dst * tpn.R3, LANES)
        want = np.asarray(jsp._run_route_stage(
            jnp.asarray(zg), jp.s3_r1, jp.s3_src, jp.s3_row, jp.s3_r2,
            jp.s3_mask, jp.n_dst, jp.R3, jp.chunk_rows, True, B=B,
        )).reshape(B, -1)
        values = torch.from_numpy(zg)
        got = rs.route_stage(values, tpn.reduce_stage).reshape(B, -1)
        single = [tpn.reduce(torch.from_numpy(zg[b]), sliced=False)
                  for b in range(B)]
    assert got.shape == (B, tpn.n_dst * tpn.chunk_rows * LANES)
    assert bits(got.numpy()) == bits(want)
    assert bits(through_offsets(values, tpn.reduce_stage)) == bits(want)
    mask = tpn.s3_mask.numpy().reshape(-1) != 0
    for b in range(B):
        assert torch.equal(got[b], single[b])
        assert not got[b].numpy()[~mask].any()


@pytest.mark.parametrize("cr", [r[2] for r in ROUTES])
@pytest.mark.parametrize("which", ["expand", "reduce"])
def test_offsets_are_minus_one_exactly_where_the_stage_gives_zero(
        routes, cr, which):
    """-1 falls on the masked outputs and on those whose block the input
    lacks (here a tenth of the block ids made to point outside the input),
    and nowhere else; every other output comes through the offsets as
    through the tables."""
    rng, _, _, _, _, tpn = routes[cr]
    st = tpn.expand_stage if which == "expand" else tpn.reduce_stage
    n, R_in, R_out = st.n_chunks, st.R_in, st.R_out
    src = st.src
    if R_in > LANES:
        src = st.src.clone()
        bad = torch.from_numpy(rng.random(src.shape) < 0.1)
        src[bad] = torch.from_numpy(rng.choice(
            [-1, R_in // LANES, 127], size=int(bad.sum()))).to(torch.int8)
    stage = rs.Stage(st.r1, src, st.row, st.r2, st.mask, n, R_in, R_out)
    assert stage.off.shape == (n, R_out, LANES)
    assert stage.off.dtype == rs.offset_dtype(R_in)
    # the outputs the tables make 0, read off the tables themselves
    ro = torch.arange(R_out).reshape(1, R_out, 1)
    zero = torch.zeros(n, R_out, LANES, dtype=torch.bool)
    if R_in > LANES:
        blk = src.long()[torch.arange(n).reshape(-1, 1, 1), ro // LANES,
                         st.r2.long(), ro % LANES]
        zero |= (blk < 0) | (blk >= R_in // LANES)
    if st.mask is not None:
        zero |= st.mask == 0
    assert torch.equal(stage.off == -1, zero)
    assert bool(zero.any()) == (R_in > LANES or st.mask is not None)
    assert int(stage.off.max()) < R_in * LANES
    x = torch.from_numpy(
        rng.normal(size=(n * R_in, LANES)).astype(np.float32))
    want = stage.reference(x)
    assert bits(through_offsets(x, stage)) == bits(want)
    want = want.reshape(n, R_out, LANES)
    assert not want[zero].any() and want[~zero].ne(0).all()


@pytest.mark.parametrize("dtype,rows,aligned,variant", [
    (torch.float32, 128, True, "shared"),
    (torch.float32, 256, True, "shared"),
    (torch.float32, 384, True, "gather"),  # 49,152 elements: int32 offsets
    (torch.float32, 512, True, "gather"),
    (torch.float64, 128, True, "shared"),
    (torch.float64, 256, True, "gather"),  # 256 KB: over a block's share
    (torch.float32, 256, False, "gather"),
    (torch.float64, 128, False, "gather"),
])
def test_stage_variant_by_dtype_rows_and_alignment(dtype, rows, aligned,
                                                   variant):
    """The shared-memory variant takes a stage whose input tile fits a
    block (227 KB) with int16 offsets and 16-byte aligned values; every
    other stage goes through L2."""
    assert rs.stage_variant(dtype, rows, aligned) == variant
    assert rs.offset_dtype(rows) == (torch.int16 if rows <= 256
                                     else torch.int32)


@pytest.mark.parametrize("qr", [1, 2, 3, 4, 7, 127, 128, 511, 2047, 65535])
def test_q_inverse_splits_quota_rows_exactly(qr):
    """The kernels' multiply-high by `q_inverse(Q)` is the division of a
    tile row by Q / 128, for every row of a tile the wrapper takes (under
    2^16 rows)."""
    ri = torch.arange(2**16, dtype=torch.int64)
    assert torch.equal((ri * rs.q_inverse(qr * LANES)) >> 32, ri // qr)


@pytest.mark.parametrize("cr", [r[2] for r in ROUTES])
def test_route_end_to_end(routes, cr):
    """Both packages' whole route equals `out[out_idx] = x[in_idx]` with
    zeros elsewhere, on the carried tables and on the port's own build,
    whose tables equal the JAX package's."""
    rng, n, out_idx, in_idx, jp, tpn = routes[cr]
    own = tsp.GlobalRoute(out_idx, in_idx, n, chunk_rows=cr,
                          device="cpu").plan
    for name in tsp.ROUTE_TABLES:
        a, b = getattr(own, name), getattr(tpn, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert all(getattr(own, k) == getattr(jp, k) for k in ROUTE_META)
    x = rng.normal(size=n).astype(np.float32)
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    for plan in (tpn, own):
        np.testing.assert_array_equal(plan(torch.from_numpy(x)).numpy(), want)


def test_route_skewed_flows():
    """Concentrated flows (a hot chunk pair) still route exactly."""
    rng = np.random.default_rng(14)
    ch = 128 * LANES
    n = 32 * ch
    hot_out = 17 * ch + rng.permutation(ch)[: ch // 8]
    hot_in = 3 * ch + rng.permutation(ch)[: ch // 8]
    rest = int(n * 0.3)
    pool_out = np.setdiff1d(np.arange(n), hot_out)
    pool_in = np.setdiff1d(np.arange(n), hot_in)
    out_idx = np.concatenate([hot_out, rng.permutation(pool_out)[:rest]])
    in_idx = np.concatenate([hot_in, rng.permutation(pool_in)[:rest]])
    plan = tsp.GlobalRoute(out_idx, in_idx, n, device="cpu").plan
    x = rng.normal(size=n).astype(np.float32)
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    np.testing.assert_array_equal(plan(torch.from_numpy(x)).numpy(), want)


def test_degenerate_route_raises():
    """Flows too concentrated for the quota (every chunk maps onto
    itself): the build raises, as the JAX package's does."""
    n = 32 * 128 * LANES
    out_idx = in_idx = np.arange(n)
    with pytest.raises(ValueError, match="degenerate"):
        tsp.GlobalRoute(out_idx, in_idx, n, device="cpu")
    with pytest.raises(ValueError, match="degenerate"):
        jsp.GlobalRoute(out_idx, in_idx, n)


def test_pair_build_equals_two_single_builds():
    rng, n, out_idx, in_idx = random_route(21, 16, 128)
    fwd, rev = tsp.build_route_pair(out_idx, in_idx, n, device="cpu")
    x = rng.normal(size=n).astype(np.float32)
    y = fwd(torch.from_numpy(x))
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    np.testing.assert_array_equal(y.numpy(), want)
    back = np.zeros(n, np.float32)
    back[in_idx] = want[out_idx]
    np.testing.assert_array_equal(rev(y).numpy(), back)
    jf, jr = jsp.build_route_pair(out_idx, in_idx, n)
    for ours, theirs in ((fwd, jf), (rev, jr)):
        for name in tsp.ROUTE_TABLES:
            a, b = getattr(ours, name), getattr(theirs, name)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# K4: the fused middle is held in test_torch_route_middle.py; here only
# where a route takes a quota of half a lane tile
# ---------------------------------------------------------------------------

def test_quota_of_half_a_lane_tile():
    """256 chunks with thin flows settle on Q = 64: the quota is no whole
    number of 128-lane tiles, so only the transposed exchange applies. The
    route and the fused middle still equal the Pallas kernels bit for
    bit."""
    rng, n, out_idx, in_idx = random_route(50, 256, 128, cover=0.45)
    ja, jb = jsp.build_route_pair(out_idx, in_idx, n)
    assert ja.Q == 64 and ja.n_src == 256
    ta, tb = route_to_port(ja), route_to_port(jb)
    x = rng.normal(size=n).astype(np.float32)
    want = np.zeros(n, np.float32)
    want[out_idx] = x[in_idx]
    zg_j = ja.expand(jnp.asarray(x))
    zg_t = ta.expand(torch.from_numpy(x))
    assert bits(zg_t.numpy()) == bits(zg_j)
    np.testing.assert_array_equal(ta.reduce(zg_t).numpy(), want)
    np.testing.assert_array_equal(np.asarray(ja.reduce(zg_j)), want)
    with pytest.raises(ValueError, match="Q % 128"):
        ta.reduce_strided(zg_t)

    lvl = level_table(rng, ja.n_dst, 128, 4)
    want_m = np.asarray(jsp._run_middle_stage(
        zg_j, jnp.asarray(lvl), ja.s3_r1, ja.s3_src, ja.s3_row, ja.s3_r2,
        ja.s3_mask, jb.s1_r1, jb.s1_src, jb.s1_row, jb.s1_r2,
        n_chunks=ja.n_dst, R_q=ja.R3, R_c=128,
        thresh=float(EM_DENOM_THRESH), max_lvl=4))
    got_m = rm.route_middle(zg_t, torch.from_numpy(lvl), ta.reduce_stage,
                            tb.expand_stage, float(EM_DENOM_THRESH), 4)
    assert bits(got_m.numpy()) == bits(want_m)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors(routes):
    _, n, _, _, _, tpn = routes[128]
    x = torch.zeros(n).reshape(-1, LANES)
    with pytest.raises(ValueError, match="CUDA"):
        rs.route_stage_cuda(x, tpn.expand_stage)
    tiles = tsp.BatchTilePermute.build(
        [tsp.DeviceTilePlan.build(np.arange(128 * LANES), 128)], device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tp.tile_permute_cuda(x[:128], tiles.stage)
    with pytest.raises(ValueError, match="CUDA"):
        rm.route_middle_cuda(x, None, tpn.reduce_stage, tpn.expand_stage,
                             0.0, 0)


def test_strided_exchange_needs_whole_lane_tiles(routes):
    _, _, _, _, _, tpn = routes[128]
    import dataclasses

    odd = dataclasses.replace(tpn, Q=tpn.Q + 64)
    with pytest.raises(ValueError, match="Q % 128"):
        odd.reduce_strided(torch.zeros(tpn.n_src * tpn.R1, LANES))


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_permute_kernel_bit_equal_to_plain_on_card(dtype):
    _skip_without_card()
    rng = np.random.default_rng(40)
    perms = [rng.permutation(512 * LANES) for _ in range(3)]
    plan = tsp.BatchTilePermute.build(
        [tsp.DeviceTilePlan.build(p, 512) for p in perms], device="cuda")
    x = torch.from_numpy(rng.normal(size=(3 * 512, LANES))).to(dtype).cuda()
    before = trace.counter("launch.tile_permute")
    got = plan(x)
    torch.cuda.synchronize()
    assert trace.counter("launch.tile_permute") == before + 1
    args = (x, plan.r1, plan.r2, plan.src, plan.lane, 512, 3)
    assert torch.equal(got.reshape(-1, LANES), tp.tile_permute_reference(*args))
    with pytest.raises(TypeError):
        plan(x.half())


@pytest.mark.cuda
@pytest.mark.parametrize("cr", [128, 256])
def test_route_stage_kernel_bit_equal_to_plain_on_card(cr):
    _skip_without_card()
    rng, n, out_idx, in_idx = random_route(41, 16, cr)
    plan = tsp.GlobalRoute(out_idx, in_idx, n, chunk_rows=cr,
                           device="cuda").plan
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).cuda()
    mul = torch.from_numpy(rng.normal(size=n).astype(np.float32)).cuda()
    before = trace.counter("launch.route_stage")
    y1 = plan.expand_y1(x, mul)
    out_s = plan.reduce_strided(y1)
    out_t = plan(x, mul)
    torch.cuda.synchronize()
    assert trace.counter("launch.route_stage") == before + 4
    cpu = plan_on_cpu(plan)
    assert torch.equal(y1.cpu(), cpu.expand_y1(x.cpu(), mul.cpu()))
    assert torch.equal(out_s, out_t)
    want = np.zeros(n, np.float32)
    want[out_idx] = (x * mul).cpu().numpy()[in_idx]
    np.testing.assert_array_equal(out_s.cpu().numpy(), want)


def plan_on_cpu(plan):
    import dataclasses

    return dataclasses.replace(plan, **{
        k: None if getattr(plan, k) is None else getattr(plan, k).cpu()
        for k in tsp.ROUTE_TABLES})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_permute_replicates_on_card(dtype):
    _skip_without_card()
    rng = np.random.default_rng(43)
    perms = [rng.permutation(256 * LANES) for _ in range(2)]
    plan = tsp.BatchTilePermute.build(
        [tsp.DeviceTilePlan.build(p, 256) for p in perms], device="cuda")
    x = torch.from_numpy(rng.normal(size=(5, 2 * 256 * LANES))).to(dtype).cuda()
    before = trace.counter("launch.tile_permute")
    got = plan(x)
    torch.cuda.synchronize()
    assert trace.counter("launch.tile_permute") == before + 1
    want = tp.tile_permute_reference(
        x.reshape(-1, LANES), plan.r1, plan.r2, plan.src, plan.lane, 256, 2,
        replicates=5)
    assert torch.equal(got.reshape(-1, LANES), want)
    for b in range(5):
        assert torch.equal(got[b], plan(x[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("cr", [128, 256])
def test_route_stage_replicate_arm_on_card(cr, B):
    """One launch for B replicates, bit-equal to the plain version and to
    B launches without the axis: expand with and without `mul`, strided
    and tile-after-tile reduce with the mask."""
    _skip_without_card()
    rng, n, out_idx, in_idx = random_route(44, 16, cr)
    plan = tsp.GlobalRoute(out_idx, in_idx, n, chunk_rows=cr,
                           device="cuda").plan
    x = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)).cuda()
    mul = torch.from_numpy(rng.normal(size=n).astype(np.float32)).cuda()
    before = trace.counter("launch.route_stage")
    y1 = plan.expand_y1_batch(x, mul)
    y1_plain = plan.expand_y1_batch(x)
    out = plan.reduce_strided_batch(y1, sliced=False)
    zg = y1.reshape(B, plan.n_src, plan.n_dst, plan.Q).transpose(1, 2)
    zg = zg.contiguous().reshape(B, plan.n_dst * plan.R3, LANES)
    s3 = (plan.s3_r1, plan.s3_src, plan.s3_row, plan.s3_r2, plan.s3_mask,
          plan.n_dst, plan.R3, cr)
    out_t = rs.route_stage(zg, plan.reduce_stage)
    torch.cuda.synchronize()
    assert trace.counter("launch.route_stage") == before + 4
    s1 = (plan.s1_r1, plan.s1_src, plan.s1_row, plan.s1_r2, None,
          plan.n_src, cr, plan.R1)
    xb = x.reshape(B, -1, LANES)
    assert torch.equal(y1, rs.route_stage_reference(
        xb, *s1, mul=mul.reshape(-1, LANES)))
    assert torch.equal(y1_plain, rs.route_stage_reference(xb, *s1))
    assert torch.equal(out, rs.route_stage_reference(
        plan.quota_view(y1), *s3).reshape(B, -1))
    assert torch.equal(out_t.reshape(B, -1), out)
    for b in range(B):
        assert torch.equal(y1[b], plan.expand_y1(x[b], mul))
        assert torch.equal(out[b], plan.reduce_strided(y1[b], sliced=False))
    want = np.zeros((B, n), np.float32)
    want[:, out_idx] = (x * mul).cpu().numpy()[:, in_idx]
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    with pytest.raises(ValueError, match="values must be"):
        rs.route_stage(xb[:, :-1], plan.expand_stage)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cr", [128, 256, 512])
def test_route_stage_variants_on_card(cr, dtype, B):
    """Every variant of the route-stage kernel against its plain version
    and, with B replicates, against B launches without the axis: the
    expand stage with and without `mul` in shared memory (f32 at 128 and
    256 rows, f64 at 128) or through L2 (the rest, and values that do not
    start on 16 bytes); the masked reduce stage on the quota view and tile
    after tile (shared memory where its input tile is 128 rows in f32)."""
    _skip_without_card()
    rng, n, out_idx, in_idx = random_route(46, 8, cr)
    plan = tsp.GlobalRoute(out_idx, in_idx, n, chunk_rows=cr,
                           device="cuda").plan
    ex, red = plan.expand_stage, plan.reduce_stage
    assert rs.stage_variant(dtype, cr) == (
        "shared" if cr * LANES * dtype.itemsize <= rs.SHARED_LIMIT
        and cr <= 256 else "gather")

    def values(*shape):
        return torch.from_numpy(rng.normal(size=shape)).to(dtype).cuda()

    x = values(B, plan.n_src * cr, LANES)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    unaligned = buf[1:].view_as(x)  # starts 4 or 8 bytes past 16
    unaligned.copy_(x)
    mul = values(plan.n_src * cr, LANES)
    y = values(B, plan.n_src * plan.R1, LANES)
    zg = y.reshape(B, plan.n_src, plan.n_dst, plan.Q).transpose(1, 2)
    zg = zg.contiguous().reshape(B, plan.n_dst * plan.R3, LANES)
    cases = [(ex, v, m) for v in (x, unaligned) for m in (None, mul)]
    cases += [(red, v, None) for v in (plan.quota_view(y), zg)]
    before = (trace.counter("launch.route_stage"),
              trace.counter("launch.route_stage.replicate"))
    for stage, v, m in cases:
        got = rs.route_stage(v, stage, mul=m)
        torch.cuda.synchronize()
        assert torch.equal(got, stage.reference(v, mul=m))
        for b in range(B):
            assert torch.equal(got[b], rs.route_stage(v[b], stage, mul=m))
    assert (trace.counter("launch.route_stage"),
            trace.counter("launch.route_stage.replicate")) == (
        before[0] + len(cases) * (1 + B), before[1] + len(cases))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n_tiles", [(256, 3), (1664, 1)])
def test_tile_permute_offsets_on_card(rows, n_tiles, dtype, B):
    """The tile permute through int16 (256 rows) and int32 (1,664 rows, the
    EM's tile) offsets: B replicates in one launch equal the plain version
    and B launches without the axis."""
    _skip_without_card()
    rng = np.random.default_rng(47)
    perms = [rng.permutation(rows * LANES) for _ in range(n_tiles)]
    plan = tsp.BatchTilePermute.build(
        [tsp.DeviceTilePlan.build(p, rows) for p in perms], device="cuda")
    assert plan.stage.off.dtype == rs.offset_dtype(rows)
    x = torch.from_numpy(
        rng.normal(size=(B, n_tiles * rows * LANES))).to(dtype).cuda()
    before = trace.counter("launch.tile_permute")
    got = plan(x)
    torch.cuda.synchronize()
    assert trace.counter("launch.tile_permute") == before + 1
    assert torch.equal(got.reshape(-1, LANES), tp.tile_permute_reference(
        x.reshape(-1, LANES), plan.r1, plan.r2, plan.src, plan.lane, rows,
        n_tiles, replicates=B))
    for b in range(B):
        assert torch.equal(got[b], plan(x[b]))


def test_native_library_loads_once_under_threads(monkeypatch):
    """The route tables are filled on a worker thread while the main thread
    colors the tile permutes. Whichever gets to the native library first
    builds and loads it; the other waits and never takes the pure-Python
    path meanwhile (its colorings are valid but different, and slow)."""
    import threading
    import time

    from oarfish_tpu_torch.kernels import build
    from oarfish_tpu_torch.ops import permute_plan

    real = build.host_library
    calls = []

    def slow_host_library(*args, **kwargs):
        calls.append(args)
        time.sleep(0.3)
        return real(*args, **kwargs)

    monkeypatch.setattr(build, "host_library", slow_host_library)
    monkeypatch.setattr(permute_plan, "_color_lib", None)
    monkeypatch.setattr(permute_plan, "_color_tried", False)
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(permute_plan._get_color_lib()))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(calls) == 1
    assert len(got) == 4 and all(g is got[0] for g in got)
