"""Fused middle (K4) of the torch port vs the Pallas kernel of the JAX
package.

The same seeded NumPy inputs and the same int8 tables (built by the JAX
package and carried across by `ops/convert.py`) go through
`static_permute._run_middle_stage` (Pallas interpret mode on the CPU) and
through the port's plain version `route_middle_reference`, which is what
the port runs for CPU tensors and what the CUDA kernel is held against on
the card. The port takes route A's reduce stage and route B's expand stage
as the `Stage`s its plans hold.

The interpret-mode outputs are made once per route and `mult`, in a module
fixture, on the quota view that the strided exchange reads: on B = 3
replicates through the kernel's replicate arm, and on replicate 0 through
the kernel without the axis. The cases of one replicate take the arm's
first replicate, and the cases on tiles that lie one after another take
the same values, exchanged into that layout (`tile_after_tile`): the same
outputs, bit for bit.

`middle_through_offsets` computes what the CUDA kernel computes, in plain
torch: the stages through their composed source offsets (-1 gives 0, the
quota view's rows split by the multiply-high of `route_stage.q_inverse`),
and each aligned block of rows added as a tree, lower half plus upper
half, where the plain version runs the butterfly over the whole tile. It
is held to the same Pallas outputs.

Tolerance: none. The middle moves f32 values, adds the rows of a group in
the order of the JAX kernel's butterfly and divides once. All outputs must
be equal bit for bit, uncovered quota slots included. (The sums in
`test_middle_denominators_are_group_sums` are NumPy's, in f64: rtol 1e-5.)
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.constants import EM_DENOM_THRESH
from oarfish_tpu.ops import static_permute as jsp
from oarfish_tpu_torch.ops import route_middle as rm
from oarfish_tpu_torch.ops import static_permute as tsp
from oarfish_tpu_torch.utils import trace
from test_torch_static_permute import (
    REPLICATES,
    bits,
    level_table,
    random_route,
    route_to_port,
    through_offsets,
)
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

LANES = 128
THRESH = float(EM_DENOM_THRESH)


def middle_through_offsets(y, lvl, a, b, thresh, max_lvl, mult=None):
    """The fused middle as its CUDA kernel computes it, in plain torch:
    route A's reduce stage through `a.off`, the tree of every aligned block
    of 2^s rows (lower half + upper half, level after level), each row
    scaled by the node of its level, route B's expand stage through
    `b.off`. Values of either layout, behind a replicate axis or not."""
    x = through_offsets(y, a)
    lead = x.shape[:-2]
    n, R_c = a.n_chunks, a.R_out
    x = x.reshape(*lead, n, R_c, LANES)
    level = lvl.reshape(n, R_c, LANES).long()
    zero = torch.zeros_like(x)
    denom = torch.where(level == 0, x, zero)
    node = x
    for s in range(1, max_lvl + 1):
        node = node[..., 0::2, :] + node[..., 1::2, :]
        denom = torch.where(level == s,
                            node.repeat_interleave(1 << s, dim=-2), denom)
    limit = torch.tensor(thresh, dtype=x.dtype)
    xs = x * torch.where(denom > limit, 1.0 / denom, zero)
    if mult is not None:
        xs = xs * mult.reshape(xs.shape)
    return through_offsets(xs.reshape(*lead, n * R_c, LANES), b)


# seed, chunks, chunk rows, max_lvl: 512 rows reach the kernel's scratch
# area in device memory, 128 and 256 its shared memory
MIDDLES = [(31, 16, 128, 5), (32, 12, 256, 7), (33, 4, 512, 3)]
CRS = [m[2] for m in MIDDLES]
ARM_B = max(REPLICATES)


@pytest.fixture(scope="module")
def middles():
    out = {}
    for seed, n_chunks, cr, max_lvl in MIDDLES:
        rng, n, out_idx, in_idx = random_route(seed, n_chunks, cr)
        ja, jb = jsp.build_route_pair(out_idx, in_idx, n, chunk_rows=cr)
        lvl = level_table(rng, ja.n_dst, cr, max_lvl)
        for L in range(-1, max_lvl + 1):
            assert (lvl == L).any(), L
        out[cr] = (rng, ja, jb, route_to_port(ja), route_to_port(jb), lvl,
                   max_lvl)
    return out


def jax_tables(ja, jb):
    return (ja.s3_r1, ja.s3_src, ja.s3_row, ja.s3_r2, ja.s3_mask, jb.s1_r1,
            jb.s1_src, jb.s1_row, jb.s1_r2)


def stages(ta, tb):
    return ta.reduce_stage, tb.expand_stage


def middle_values(rng, B, n_q, n_c, with_mult):
    """Positive and negative values, exact zeros, and tiny values of either
    sign that meet the denominator threshold from both sides, none so small
    that a scaled one would be subnormal (XLA's CPU backend flushes
    subnormals to zero, torch does not); `mult` small integers."""
    y = rng.normal(size=(B, n_q, LANES)).astype(np.float32)
    y[rng.random(y.shape) < 0.05] = 0.0
    tiny = rng.random(y.shape) < 0.02
    y[tiny] = np.copysign(
        1e-32 * rng.uniform(0.5, 2.0, size=int(tiny.sum())), y[tiny])
    mult = (rng.integers(0, 4, size=(B, n_c, LANES)).astype(np.float32)
            if with_mult else None)
    return y, mult


def run_pallas(ja, jb, lvl, y, mult, max_lvl, strided, B):
    """`_run_middle_stage` in interpret mode; B = 0: no replicate axis."""
    qr = ja.Q // LANES if strided else 0
    yj = jnp.asarray(y)
    if strided:
        yj = yj.reshape(*y.shape[:-2], ja.n_src, ja.n_dst, qr, LANES)
    return np.asarray(jsp._run_middle_stage(
        yj, jnp.asarray(lvl), *jax_tables(ja, jb), n_chunks=ja.n_dst,
        R_q=ja.R3, R_c=ja.chunk_rows, thresh=THRESH, max_lvl=max_lvl,
        mult=None if mult is None else jnp.asarray(mult), strided_qr=qr,
        B=B))


@pytest.fixture(scope="module")
def middle_refs(middles):
    """(y, mult, want) per route and `mult`, made at first use: `y` the
    values of ARM_B replicates as the quota tensor of the strided exchange,
    `want[B]` for B = ARM_B (the Pallas kernel's replicate arm on all
    replicates) and B = 0 (the kernel without the axis on replicate 0)."""
    cache = {}

    def get(cr, with_mult):
        key = (cr, with_mult)
        if key not in cache:
            rng, ja, jb, ta, _, lvl, max_lvl = middles[cr]
            rng = np.random.default_rng([cr, int(with_mult)])
            y, mult = middle_values(rng, ARM_B, ta.n_dst * ta.R3,
                                    ta.n_dst * cr, with_mult)
            want = {ARM_B: run_pallas(ja, jb, lvl, y, mult, max_lvl, True,
                                      ARM_B),
                    0: run_pallas(ja, jb, lvl, y[0],
                                  None if mult is None else mult[0],
                                  max_lvl, True, 0)}
            # the JAX kernel's own promise: a replicate of the arm is what
            # a launch without the axis gives
            assert bits(want[ARM_B][0]) == bits(want[0])
            if with_mult:
                # and its tile-after-tile arm, once per chunk size, gives
                # the same outputs on the same values in that layout: the
                # witness for the port's tile-after-tile cases below
                flat = run_pallas(ja, jb, lvl, tile_after_tile(ta, y[0]),
                                  mult[0], max_lvl, False, 0)
                assert bits(flat) == bits(want[0])
            cache[key] = (y, mult, want)
        return cache[key]

    return get


def tile_after_tile(ta, yq):
    """The quota tensor of the strided exchange (behind a replicate axis or
    not) as tiles that lie one after another: chunk j's tile is its column
    `[:, j]`, the other layout of the same values."""
    lead = yq.shape[:-2]
    zg = yq.reshape(*lead, ta.n_src, ta.n_dst, ta.Q).swapaxes(-3, -2)
    return np.ascontiguousarray(zg).reshape(*lead, ta.n_dst * ta.R3, LANES)


def port_values(ta, y, strided):
    """The port's values for a case: the quota view of `y`, or the same
    values tile after tile."""
    if strided:
        return ta.quota_view(torch.from_numpy(np.ascontiguousarray(y)))
    return torch.from_numpy(tile_after_tile(ta, y))


@pytest.mark.parametrize("cr", CRS)
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("with_mult", [False, True])
def test_middle_bit_equal_to_pallas(middles, middle_refs, cr, strided,
                                    with_mult):
    _, _, _, ta, tb, lvl, max_lvl = middles[cr]
    y, mult, want = middle_refs(cr, with_mult)
    values = port_values(ta, y[0], strided)
    tl = torch.from_numpy(lvl)
    tm = None if mult is None else torch.from_numpy(mult[0])
    got = rm.route_middle(values, tl, *stages(ta, tb), THRESH, max_lvl,
                          mult=tm)
    assert got.shape == (ta.n_dst * ta.R3, LANES)
    assert got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    assert bits(got.numpy()) == bits(want[0])
    assert bits(middle_through_offsets(values, tl, *stages(ta, tb), THRESH,
                                       max_lvl, tm)) == bits(want[0])


@pytest.mark.parametrize("B", REPLICATES)
@pytest.mark.parametrize("cr", CRS)
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("with_mult", [False, True])
def test_middle_replicates_bit_equal_to_pallas(middles, middle_refs, cr,
                                               strided, with_mult, B):
    """Values, `mult` and output with a leading replicate axis; stages and
    `lvl` shared. Each replicate also equals a call without the axis."""
    _, _, _, ta, tb, lvl, max_lvl = middles[cr]
    y, mult, want = middle_refs(cr, with_mult)
    y = y[:B]
    values = port_values(ta, y, strided)
    tl = torch.from_numpy(lvl)
    tmult = None if mult is None else torch.from_numpy(mult[:B])
    got = rm.route_middle(values, tl, *stages(ta, tb), THRESH, max_lvl,
                          mult=tmult)
    assert got.shape == (B, ta.n_dst * ta.R3, LANES)
    assert got.dtype == torch.float32
    assert bits(got.numpy()) == bits(want[ARM_B][:B])
    assert bits(middle_through_offsets(values, tl, *stages(ta, tb), THRESH,
                                       max_lvl, tmult)) == bits(
        want[ARM_B][:B])
    for b in range(B):
        one = rm.route_middle(
            port_values(ta, y[b], strided), tl, *stages(ta, tb), THRESH,
            max_lvl, mult=None if tmult is None else tmult[b])
        assert torch.equal(got[b], one)


def irregular_levels(rng, n_chunks, cr, max_lvl, layout):
    """Level tables that `em_v4._read_lvl_ids` never writes, but which the
    butterfly and the kernel's tree both take.

    unequal_groups: in every chunk one aligned group of 2^max_lvl rows and
        aligned groups of random smaller sizes around it, a fifth of them
        tagged -1 or max_lvl + 1 (no data);
    any_level: every element its own level in -1..max_lvl + 1, whatever its
        neighbours' (rows of one aligned block name different levels, and a
        lane may differ from the next)."""
    if layout == "any_level":
        return rng.integers(-1, max_lvl + 2,
                            size=(n_chunks * cr, LANES)).astype(np.int8)
    lvl = np.full(n_chunks * cr, -1, dtype=np.int8)
    top = 1 << max_lvl
    for c in range(n_chunks):
        base = c * cr
        p = int(rng.integers(0, cr // top)) * top
        lvl[base + p: base + p + top] = max_lvl
        r = 0
        while r < cr:
            if r == p:
                r += top
                continue
            L = int(rng.integers(0, max_lvl))
            while r % (1 << L) or r + (1 << L) > (p if r < p else cr):
                L -= 1
            tag = L if rng.random() > 0.2 else int(rng.choice([-1,
                                                               max_lvl + 1]))
            lvl[base + r: base + r + (1 << L)] = tag
            r += 1 << L
        if top < cr:
            assert len(set(lvl[base: base + cr].tolist())) > 2
    return np.ascontiguousarray(np.broadcast_to(lvl[:, None],
                                                (n_chunks * cr, LANES)))


@pytest.mark.parametrize("layout", ["unequal_groups", "any_level"])
@pytest.mark.parametrize("with_mult", [False, True])
def test_middle_irregular_levels_bit_equal_to_pallas(middles, layout,
                                                     with_mult):
    """Groups that reach max_lvl beside groups of other sizes in one
    chunk, and levels that vary inside an aligned block: the plain version
    and the kernel's tree both give the Pallas kernel's bits (256 rows,
    max_lvl 7, the tree's levels 5 to 7 above a thread's 16 rows)."""
    _, ja, jb, ta, tb, _, max_lvl = middles[256]
    rng = np.random.default_rng([40, int(with_mult),
                                 int(layout == "any_level")])
    lvl = irregular_levels(rng, ta.n_dst, 256, max_lvl, layout)
    y, mult = middle_values(rng, 1, ta.n_dst * ta.R3, ta.n_dst * 256,
                            with_mult)
    m = None if mult is None else mult[0]
    want = run_pallas(ja, jb, lvl, y[0], m, max_lvl, True, 0)
    values = port_values(ta, y[0], True)
    tl = torch.from_numpy(lvl)
    tm = None if m is None else torch.from_numpy(m)
    got = rm.route_middle(values, tl, *stages(ta, tb), THRESH, max_lvl,
                          mult=tm)
    assert bits(got.numpy()) == bits(want)
    assert bits(middle_through_offsets(values, tl, *stages(ta, tb), THRESH,
                                       max_lvl, tm)) == bits(want)


def test_middle_denominators_are_group_sums(middles):
    """What the butterfly computes, said directly: every row of an aligned
    group of 2^L rows is divided by the group's sum at its lane; rows with
    level -1 and groups whose sum is not above the threshold give 0."""
    rng, _, _, ta, tb, lvl, max_lvl = middles[256]
    cr, n = 256, ta.n_dst
    a, b = stages(ta, tb)
    y = rng.uniform(0.5, 2.0, size=(n * ta.R3, LANES)).astype(np.float32)
    x = a.reference(torch.from_numpy(y)).reshape(n, cr, LANES).numpy()
    xs = np.zeros_like(x, dtype=np.float64)
    for c in range(n):
        r = 0
        while r < cr:
            L = int(lvl[c * cr + r, 0])
            K = 1 << max(L, 0)
            if L >= 0:
                d = x[c, r:r + K].astype(np.float64).sum(axis=0)
                ok = d > EM_DENOM_THRESH
                xs[c, r:r + K] = np.where(ok, x[c, r:r + K] / np.where(ok, d, 1), 0)
            r += K
    want = b.reference(torch.from_numpy(
        xs.astype(np.float32)).reshape(n * cr, LANES))
    got = rm.route_middle(torch.from_numpy(y), torch.from_numpy(lvl), a, b,
                          THRESH, max_lvl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("cr,max_lvl", [(128, 8), (256, 9), (384, 8)])
def test_middle_refuses_levels_beyond_a_chunk(middles, cr, max_lvl):
    """Every level's aligned blocks must tile a chunk (the butterfly would
    otherwise wrap around it); the stages must take each other's rows."""
    with pytest.raises(ValueError, match="max_lvl"):
        rm.check_levels(max_lvl, cr)
    ta, tb = middles[128][3], middles[256][4]
    with pytest.raises(ValueError, match="does not take"):
        rm.check_stages(ta.reduce_stage, tb.expand_stage)
    assert rm.tree_rows(256, 4) == 0 and rm.tree_rows(256, 6) == 16 + 8 + 4


@pytest.mark.parametrize("cr,max_lvl", [(128, 3), (128, 7), (256, 4),
                                         (256, 6), (512, 9), (2048, 11)])
def test_tree_rows_match_the_kernel(cr, max_lvl):
    """The wrapper sizes a block's area with its own copies of the kernel's
    constants and of its `tree_rows`: they must match the kernel source,
    and count one node per aligned block of 2^s rows for each level s from
    the segment's up to max_lvl (none where a segment holds every level)."""
    src = (Path(rm.__file__).parent.parent / "csrc" /
           "route_middle.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["SEG_LOG"] == rm.SEGMENT_LEVELS
    assert consts["MAX_LEVELS"] == rm.MAX_LEVELS
    nodes = ({(s, r >> s) for r in range(cr)
              for s in range(rm.SEGMENT_LEVELS, max_lvl + 1)}
             if max_lvl > rm.SEGMENT_LEVELS else set())
    assert rm.tree_rows(cr, max_lvl) == len(nodes)


@pytest.mark.parametrize("dtype,cr,max_lvl,variant", [
    (torch.float32, 128, 7, "block"), (torch.float32, 256, 6, "block"),
    (torch.float32, 256, 8, "block"), (torch.float32, 512, 3, "scratch"),
    (torch.float64, 128, 7, "block"), (torch.float64, 256, 3, "scratch"),
])
def test_middle_variant_by_dtype_rows_and_levels(dtype, cr, max_lvl,
                                                 variant):
    """One block keeps the chunk and its tree in shared memory where they
    fit 227 KB (a 256-row f32 chunk with max_lvl 6: 142 KB); else the
    scratch area in device memory."""
    assert rm.middle_variant(dtype, cr, max_lvl) == variant


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def card_case(seed, cr, dtype, B, max_lvl, layout="groups"):
    rng, n, out_idx, in_idx = random_route(seed, 8, cr)
    fa, fb = tsp.build_route_pair(out_idx, in_idx, n, chunk_rows=cr,
                                  device="cuda")
    if layout == "groups":
        lvl = level_table(rng, fa.n_dst, cr, max_lvl)
    else:
        lvl = irregular_levels(rng, fa.n_dst, cr, max_lvl, layout)
    lead = (B,) if B else ()
    y = torch.from_numpy(rng.normal(
        size=(*lead, fa.n_dst * fa.R3, LANES))).to(dtype).cuda()
    mult = torch.from_numpy(rng.integers(
        0, 4, size=(*lead, fa.n_dst * cr, LANES)).astype(np.float64)
    ).to(dtype).cuda()
    return fa, fb, torch.from_numpy(lvl).cuda(), y, mult


@pytest.mark.cuda
@pytest.mark.parametrize("cr,dtype,max_lvl", [
    (128, torch.float32, 6), (128, torch.float32, 7),
    (256, torch.float32, 3), (256, torch.float32, 8),
    (512, torch.float32, 6), (512, torch.float32, 9),
    (256, torch.float64, 6), (128, torch.float64, 4)])
def test_middle_kernel_bit_equal_to_plain_on_card(cr, dtype, max_lvl):
    """The chunk in its block's shared memory (128 rows, and 256 in f32)
    and in the scratch area in device memory (512 rows, and 256 in f64);
    with and without `mult`, on both value layouts. max_lvl at most 4
    needs no tree area; up to log2 of the chunk's rows every level of the
    tree."""
    _skip_without_card()
    fa, fb, lvl, y, mult = card_case(42, cr, dtype, 0, max_lvl)
    a, b = stages(fa, fb)
    before = (trace.counter("launch.route_middle"),
              trace.counter("launch.route_middle.replicate"))
    for m in (None, mult):
        for values in (y, fa.quota_view(y)):
            got = rm.route_middle(values, lvl, a, b, THRESH, max_lvl, mult=m)
            torch.cuda.synchronize()
            assert torch.equal(
                got, rm.route_middle_reference(values, lvl, a, b, THRESH,
                                               max_lvl, mult=m))
    assert (trace.counter("launch.route_middle"),
            trace.counter("launch.route_middle.replicate")) == (
        before[0] + 4, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["unequal_groups", "any_level"])
@pytest.mark.parametrize("dtype,max_lvl", [(torch.float32, 7),
                                           (torch.float64, 7),
                                           (torch.float32, 8)])
def test_middle_kernel_irregular_levels_on_card(layout, dtype, max_lvl):
    """Level tables that no layout writes (groups of mixed sizes up to
    max_lvl in one chunk, levels varying inside a block and across lanes):
    the kernel's tree gives the butterfly's bits, in shared memory (f32)
    and in the scratch area (f64)."""
    _skip_without_card()
    fa, fb, lvl, y, mult = card_case(48, 256, dtype, 0, max_lvl, layout)
    a, b = stages(fa, fb)
    values = fa.quota_view(y)
    for m in (None, mult):
        got = rm.route_middle(values, lvl, a, b, THRESH, max_lvl, mult=m)
        torch.cuda.synchronize()
        assert torch.equal(got, rm.route_middle_reference(
            values, lvl, a, b, THRESH, max_lvl, mult=m))


@pytest.mark.cuda
@pytest.mark.parametrize("cr,dtype,max_lvl", [
    (128, torch.float32, 6), (256, torch.float32, 6),
    (512, torch.float32, 6), (256, torch.float64, 6),
    (128, torch.float32, 7), (512, torch.float32, 9)])
def test_middle_replicate_arm_on_card(cr, dtype, max_lvl):
    """One launch for B = 3 replicates, the chunk in shared memory (128 and
    256 rows in f32) and in the scratch area in device memory (512 rows,
    and 256 in f64): bit-equal to the plain version and to 3 launches
    without the axis, with and without `mult`, on both value layouts."""
    _skip_without_card()
    B = 3
    fa, fb, lvl, y, mult = card_case(45, cr, dtype, B, max_lvl)
    a, b = stages(fa, fb)
    before = (trace.counter("launch.route_middle"),
              trace.counter("launch.route_middle.replicate"))
    for m in (None, mult):
        for values in (y, fa.quota_view(y)):
            got = rm.route_middle(values, lvl, a, b, THRESH, max_lvl, mult=m)
            torch.cuda.synchronize()
            assert got.shape == (B, fa.n_dst * fa.R3, LANES)
            assert torch.equal(got, rm.route_middle_reference(
                values, lvl, a, b, THRESH, max_lvl, mult=m))
    for i in range(B):
        one = rm.route_middle(fa.quota_view(y[i]), lvl, a, b, THRESH,
                              max_lvl, mult=mult[i])
        assert torch.equal(got[i], one)
    assert (trace.counter("launch.route_middle"),
            trace.counter("launch.route_middle.replicate")) == (
        before[0] + 4 + B, before[1] + 4)
    with pytest.raises(ValueError, match="mult"):
        rm.route_middle(y, lvl, a, b, THRESH, max_lvl, mult=mult[0])
