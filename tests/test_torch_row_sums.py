"""The fixed-order row sums of the routed EM's glue (`ops/row_sums.py`).

On the CPU the plain version is held bit for bit against the JAX
package's bucket row sums (`oarfish_tpu/ops/em_v4.py::_row_sums`, XLA's
reduction) on bucket layouts with the power-of-two widths of the v4
layout, with gaps between buckets and a tail, f32 and f64; every
replicate of a batch gets the bits it gets alone; the second level
(consecutive runs, `segment_table`) follows the kernel's order, emulated
here one addition at a time; malformed tables are refused. The
one-launch plans (`RowSumPlan`: the rows, a second level over groups of
them, a zero tail) cover every output and needed row once, and a NumPy
model of the kernel's work split (a window a thread, the upper levels in
shared memory, each group added by the tile that arrives last) gives
the plain version's bits; the v4 transcript tail through its plan gives
the bits of the two launches and glue it replaced. On the card (`cuda`)
the kernel is bit-equal to its plain version, alone and at 1, 3 and 8
replicates, launched again after another batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops.em_v4 import _row_sums as jax_row_sums
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops import row_sums as trs
from oarfish_tpu_torch.utils import trace
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

# (rows_pad, K) of a layout: every width of the read buckets and of the
# transcript buckets up to CAPK, with the big region's CAPK-wide rows
SHAPES = [(256, 1), (128, 2), (384, 4), (128, 8), (256, 16), (128, 32),
          (128, 64), (128, 128), (128, 256), (128, 512), (128, 1024),
          (256, tv4.CAPK)]


def layout(rng, gaps: bool):
    """Bucket starts with (or without) a gap of whole 128-lane rows before
    each bucket; the slot count with a tail of rows."""
    starts, pos = [], 0
    for rows_pad, K in SHAPES:
        if gaps:
            pos += 128 * int(rng.integers(0, 3))
        starts.append(pos)
        pos += rows_pad * K
    return starts, pos + 128 * 3


def kernel_order(values, K):
    """The kernel's loop nest (`csrc/row_sums.cu::window_sum`), one
    addition at a time."""
    top = None
    s = 0
    while s * 1024 < K:
        mid = None
        for c in range(s * 32, min((s + 1) * 32, -(-K // 32))):
            inner = values[c * 32]
            for k in range(c * 32 + 1, min(c * 32 + 32, K)):
                inner = inner + values[k]
            mid = inner if c == s * 32 else mid + inner
        top = mid if s == 0 else top + mid
        s += 1
    return top


@pytest.mark.parametrize("gaps", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bucket_sums_equal_the_jax_package(dtype, gaps):
    rng = np.random.default_rng(1)
    starts, n = layout(rng, gaps)
    x = rng.random(n).astype(dtype)
    table = trs.bucket_table(SHAPES, starts, "cpu")
    got = trs.row_sums(torch.from_numpy(x), table).numpy()
    want = np.asarray(jax_row_sums(jnp.asarray(x), SHAPES, starts))
    assert got.dtype == want.dtype and got.shape == (table.n_out,)
    np.testing.assert_array_equal(got, want)


def test_replicates_get_the_bits_they_get_alone():
    rng = np.random.default_rng(2)
    starts, n = layout(rng, True)
    table = trs.bucket_table(SHAPES, starts, "cpu")
    x = torch.from_numpy(rng.random((3, n)).astype(np.float32))
    batch = trs.row_sums(x, table)
    assert batch.shape == (3, table.n_out)
    for b in range(3):
        assert torch.equal(trs.row_sums(x[b], table), batch[b])


@pytest.mark.parametrize("K", [1, 5, 32, 33, 100, 1024, 1500, 4100])
def test_segments_follow_the_kernel_order(K):
    rng = np.random.default_rng(K)
    x = rng.random(K + 20).astype(np.float32)
    offsets = np.array([0, 3, 3 + K])
    table = trs.segment_table(offsets, 7, "cpu")
    got = trs.row_sums(torch.from_numpy(x), table).numpy()
    assert got[0] == kernel_order(x[7:], 3)
    assert got[1] == kernel_order(x[10:], K)
    np.testing.assert_allclose(got[1], x[10 : 10 + K].astype(np.float64).sum(),
                               rtol=1e-5)


def test_bucket_order_is_the_kernel_order():
    """Row 3 of a 2048-wide bucket, added one value at a time in the
    kernel's order."""
    rng = np.random.default_rng(4)
    K = 2048
    x = rng.random(128 * K).astype(np.float32)
    table = trs.bucket_table([(128, K)], [0], "cpu")
    got = trs.row_sums(torch.from_numpy(x), table).numpy()
    assert got[3] == kernel_order(x[3::128], K)


@pytest.mark.parametrize("entries,n_out", [
    ([(1, 0, 1, 1)], 1),             # outputs must start at 0
    ([(0, 0, 0, 1)], 1),             # K >= 1
    ([(0, 0, 2, 128)], 100),         # whole rows of 128
    ([(0, 0, 32**3 + 1, 1)], 1),     # the kernel's three levels
    ([(0, 0, 1, 1), (0, 1, 1, 1)], 2),  # ascending first outputs
])
def test_malformed_tables_are_refused(entries, n_out):
    with pytest.raises(ValueError):
        trs.RowSumTable.make(entries, n_out, "cpu")


def test_values_too_short_or_elsewhere_are_refused():
    table = trs.bucket_table([(128, 4)], [128], "cpu")
    assert table.n_in == 128 + 512
    with pytest.raises(ValueError, match="table reads"):
        trs.row_sums(torch.zeros(600), table)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trs.row_sums_cuda(torch.zeros(640), table)
    with pytest.raises(TypeError):
        trs.row_sums(torch.zeros(640, dtype=torch.float16), table)


@pytest.fixture(scope="module")
def v4_data():
    """A small routed layout with big transcripts (CPU)."""
    rng = np.random.default_rng(5)
    R, T = 20_000, 300
    sizes = rng.geometric(1 / 3, size=R).clip(1, 30)
    boundaries = np.concatenate([[0], np.cumsum(sizes)])
    txp_id = (rng.zipf(1.3, size=int(boundaries[-1])) % T).astype(np.int32)
    data, _ = tv4.EmV4Data.build(txp_id, np.ones(len(txp_id)), boundaries, T,
                                 device="cpu")
    return data


def test_v4_layout_tables(v4_data):
    """An `EmV4Data`'s tables read what the glue hands them: the
    transcript layout's slots, its row sums for the big region's second
    level and the zero pad up to `t_space` (one plan), the read layout's
    slots."""
    data = v4_data
    n_t = data.p_a.n_src * data.p_a.chunk_rows * 128
    assert data.txp_sum_table.n_in <= n_t
    assert data.txp_sum_table.n_out == data.row_space_s + data.big_rows_pad
    assert data.read_sum_table.n_out == data.row_space_r
    plan = data.tail_plan
    assert plan.n_in == data.txp_sum_table.n_in
    assert (plan.first, plan.n_out) == (data.row_space_s, data.t_space)
    assert len(plan.groups) == data.n_big > 0
    assert plan.offsets[-1] <= data.big_rows_pad


@pytest.mark.cuda
@pytest.mark.parametrize("replicates", [0, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_version_on_the_card(dtype, replicates):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    starts, n = layout(rng, True)
    shape = (replicates, n) if replicates else (n,)
    x = torch.as_tensor(rng.random(shape), dtype=dtype, device="cuda")
    for table in (trs.bucket_table(SHAPES, starts, "cuda"),
                  trs.segment_table(np.array([0, 1, 40, 2100, 30000]), 9,
                                    "cuda")):
        before = trace.counter("launch.row_sums")
        got = trs.row_sums(x, table)
        torch.cuda.synchronize()
        assert trace.counter("launch.row_sums") == before + 1
        assert torch.equal(got.cpu(), trs.row_sums_reference(x.cpu(), table))


# ---------------------------------------------------------------------------
# the one-launch plan (`RowSumPlan`): its tiles, the kernel's work split
# ---------------------------------------------------------------------------

def random_plan(rng, groups, widths=(1, 5, 32, 33, 100, 1500, 2048)):
    """A transcript-tail-like plan: W = 128 buckets of the given widths
    (with gaps), a W = 1 run, then a region of 40-wide rows whose leading
    rows form the second level's groups (`groups` rows each, the rest pad
    rows), and a zero tail."""
    entries, pos, off = [], 0, 0
    for K in widths:
        pos += 128 * int(rng.integers(0, 3))
        rows = 128 * int(rng.integers(1, 4))
        entries.append((off, pos, K, 128))
        pos += rows * K
        off += rows
    for K in (3, 70):  # runs of consecutive values, one output each
        entries.append((off, pos, K, 1))
        pos += K
        off += 1
    first = off
    offsets = np.concatenate([[0], np.cumsum(groups)])
    big_rows = -(-(int(offsets[-1]) + 5) // 128) * 128
    entries.append((off, pos, 40, 128))
    pos += big_rows * 40
    table = trs.RowSumTable.make(entries, off + big_rows, "cpu")
    n_out = first + len(groups) + int(rng.integers(0, 9000))
    return trs.RowSumPlan.make(table, n_out, first, offsets), pos + 7


def bench_like_plan(rng):
    """The bench plan's transcript tail in shape (PERF.md section 4): the
    12 power-of-two widths up to CAPK, 161 big transcripts of 2 or more
    CAPK-wide rows (one of more than 1,024), about 147,712 sums."""
    shapes, starts, pos = [], [], 0
    for K in 2 ** np.arange(12):
        rows = 128 * max(1, int(40_000 / K ** 1.2) // 128)
        shapes.append((rows, int(K)))
        starts.append(pos)
        pos += rows * int(K)
    first = sum(r for r, _ in shapes)
    big = np.concatenate([rng.integers(2, 40, size=160), [1100]])
    offsets = np.concatenate([[0], np.cumsum(big)])
    big_rows = -(-int(offsets[-1]) // 128) * 128
    shapes.append((big_rows, tv4.CAPK))
    starts.append(pos)
    table = trs.bucket_table(shapes, starts, "cpu")
    return trs.RowSumPlan.make(table, first + 161 + 3000, first, offsets)


def check_cover(plan):
    """Every output written once, every row the plan needs summed once
    (rows of no group never), every scratch slot written once; each tile
    within the kernel's shared memory; each group's count of tiles
    right."""
    t, table = plan.tiles, plan.table
    G = len(plan.groups)
    written = np.zeros(plan.n_out, np.int64)
    rows = np.zeros(table.n_out, np.int64)
    slots = np.zeros(int(plan.offsets[-1]), np.int64)
    touched = np.zeros(G, np.int64)  # tiles whose rows fall in each group

    def group_of(slot):
        return int(np.searchsorted(plan.offsets, slot, side="right")) - 1

    for dest, base, q0, n, K, W, g in t.tolist():
        assert 1 <= n
        if K == 0:
            written[dest : dest + n] += 1
            continue
        e = np.nonzero(table.entries[:, 1] == base)[0]
        assert len(e) == 1 and (table.entries[e[0], 2:] == (K, W)).all()
        o = int(table.entries[e[0], 0])
        assert n <= trs.THREADS
        nw = -(-K // trs.WINDOW)
        assert n * nw <= trs.WS_SLOTS
        assert nw <= trs.WINDOW or n * -(-nw // trs.WINDOW) <= trs.MID_SLOTS
        rows[o + q0 : o + q0 + n] += 1
        if g < 0:
            assert dest == o + q0
            written[dest : dest + n] += 1
        else:
            assert dest == o + q0 - plan.first
            slots[dest : dest + n] += 1
            assert plan.offsets[g] <= dest < plan.offsets[g + 1]
            touched[g : group_of(dest + n - 1) + 1] += 1
    written[plan.first : plan.first + G] += 1
    assert (written == 1).all()
    need = np.zeros(table.n_out, np.int64)
    need[: plan.first] = 1
    need[plan.first : plan.first + int(plan.offsets[-1])] = 1
    assert np.array_equal(rows, need)
    assert (slots == 1).all()
    assert np.array_equal(plan.groups[:, 3], touched)
    assert np.array_equal(plan.groups[:, 2], np.diff(plan.offsets))
    assert plan.values_read == int((t[:, 3] * t[:, 4]).sum())


def windows(src, idx, n):
    """Windows of `src` `[B, m]`: row r adds `src[:, idx[r, i]]` for
    i < n[r] in index order (`csrc/row_sums.cu::window`)."""
    valid = np.arange(32)[None] < n[:, None]
    assert idx[valid].max() < src.shape[-1]
    v = src[:, np.where(valid, idx, 0)]
    ws = v[..., 0].copy()
    for i in range(1, 32):
        ws = np.where(valid[:, i], ws + v[..., i], ws)
    return ws


def block_sums(src, base, q0, lanes, K, W):
    """`csrc/row_sums.cu::block_sums` on `src` `[B, m]`: thread p adds
    window p // lanes of output q0 + p % lanes; the window sums go to
    shared memory, windows of 32 of them are added in index order by one
    thread each, then those by one thread per output."""
    nw = -(-K // 32)
    assert lanes * nw <= trs.WS_SLOTS
    p = np.arange(lanes * nw)
    q, j = q0 + p % lanes, p // lanes
    row = base + (q // W) * K * W + q % W
    k0 = j * 32
    ws = windows(src, row[:, None] + (k0[:, None] + np.arange(32)[None]) * W,
                 np.minimum(32, K - k0))

    def seq(a, parts):  # lane-wise: part 0 + part 1 + ... in order
        acc = a[:, :lanes].copy()
        for c in range(1, parts):
            acc = acc + a[:, c * lanes : (c + 1) * lanes]
        return acc

    if nw <= 32:
        return seq(ws, nw)
    nc = -(-nw // 32)
    assert lanes * nc <= trs.MID_SLOTS
    mid = np.empty((src.shape[0], lanes * nc), src.dtype)
    for c in range(nc):
        acc = ws[:, c * 32 * lanes : c * 32 * lanes + lanes].copy()
        for jj in range(c * 32 + 1, min((c + 1) * 32, nw)):
            acc = acc + ws[:, jj * lanes : (jj + 1) * lanes]
        mid[:, c * lanes : (c + 1) * lanes] = acc
    return seq(mid, nc)


def warp_sum(src, first, n):
    """`csrc/row_sums.cu::warp_sum`: lane i of a warp adds windows i,
    i + 32, ... of `src[:, first : first + n]`; each run of 32 window sums
    is added in index order, then those."""
    nw = -(-n // 32)
    k0 = np.arange(nw) * 32
    ws = windows(src, first + k0[:, None] + np.arange(32)[None],
                 np.minimum(32, n - k0))
    top = None
    for c in range(-(-nw // 32)):
        mid = ws[:, c * 32]
        for i in range(c * 32 + 1, min(c * 32 + 32, nw)):
            mid = mid + ws[:, i]
        top = mid if c == 0 else top + mid
    return top


def emulate(x: np.ndarray, plan, rng) -> np.ndarray:
    """NumPy model of one launch of the kernel on `x` `[B, n]`: the tiles
    in a random order (blocks run in any order), each group added by the
    last of the tiles whose rows fall in it to arrive, from the scratch
    slots in index order."""
    B = x.shape[0]
    out = np.full((B, plan.n_out), np.nan, x.dtype)
    scratch = np.full((B, max(int(plan.offsets[-1]), 1)), np.nan, x.dtype)
    arrived = np.zeros(len(plan.groups), np.int64)
    for dest, base, q0, n, K, W, g in plan.tiles[
            rng.permutation(len(plan.tiles))].tolist():
        if K == 0:
            out[:, dest : dest + n] = 0
            continue
        res = block_sums(x, base, q0, n, K, W)
        if g < 0:
            out[:, dest : dest + n] = res
            continue
        scratch[:, dest : dest + n] = res
        g_end = int(np.searchsorted(plan.offsets, dest + n - 1,
                                    side="right"))
        for gi in range(g, g_end):
            arrived[gi] += 1
            if arrived[gi] == plan.groups[gi, 3]:
                gpos, s0, rows, _ = plan.groups[gi].tolist()
                out[:, gpos] = warp_sum(scratch, s0, rows)
    assert (arrived == plan.groups[:, 3]).all()
    return out


def test_plan_covers_every_output_once():
    """Random layouts with big-transcript groups of 1, 33 and more than
    1,024 rows, and the bench-like layout (this file keeps at most 30
    tests: see README.md on the order in which the test workers take the
    files)."""
    for seed in (0, 1):
        for groups in ([1], [33], [1, 33, 1100], [2, 1, 40]):
            plan, _ = random_plan(np.random.default_rng(seed), groups)
            check_cover(plan)
    plan = bench_like_plan(np.random.default_rng(9))
    assert len(plan.groups) == 161 and plan.groups[:, 2].max() == 1100
    # a 2048-wide row: 32 neighbouring outputs a tile (a 128-byte line),
    # across the big transcripts' edges
    big = plan.tiles[plan.tiles[:, 6] >= 0]
    assert (big[:, 4] == tv4.CAPK).all() and (big[:-1, 3] == 32).all()
    check_cover(plan)


def test_work_split_gives_the_plain_bits():
    """The kernel's work split, emulated in NumPy, against the plain
    version, bit for bit: plans with a second level for 2 replicates, f32
    and f64, and tables alone."""
    for dtype in (np.float32, np.float64):
        for groups in ([1, 33, 1100], [5, 1, 2]):
            rng = np.random.default_rng(len(groups))
            plan, n = random_plan(rng, groups)
            x = rng.random((2, n)).astype(dtype)
            want = trs.row_sums(torch.from_numpy(x), plan).numpy()
            assert want.shape == (2, plan.n_out)
            np.testing.assert_array_equal(emulate(x, plan, rng), want,
                                          err_msg=f"{dtype} {groups}")
            assert not want[:, plan.first + len(groups):].any()
    # a table alone (the read layout's denominators, `segment_table`)
    # runs as `table.plan`: every output written straight out
    rng = np.random.default_rng(7)
    starts, n = layout(rng, True)
    x = rng.random((1, n)).astype(np.float32)
    for table in (trs.bucket_table(SHAPES, starts, "cpu"),
                  trs.segment_table(np.array([0, 1, 40, 2100, 30000]), 9,
                                    "cpu")):
        plan = table.plan
        assert len(plan.groups) == 0 and plan.n_out == table.n_out
        check_cover(plan)
        want = trs.row_sums_reference(torch.from_numpy(x), table).numpy()
        np.testing.assert_array_equal(emulate(x, plan, rng), want)


def old_tail(data, inc_t):
    """The transcript tail as two launches and glue composed it before the
    one-launch plan: row sums, the big transcripts' second level over
    them, concatenated with zeros, then `t_out`."""
    lead = inc_t.shape[:-1]
    sums = trs.row_sums_reference(inc_t, data.txp_sum_table)
    parts = [sums[..., : data.row_space_s]]
    n = data.row_space_s
    if data.big_rows_pad:
        big = trs.segment_table(data.big_row_offsets.numpy(),
                                data.row_space_s, "cpu")
        parts.append(trs.row_sums_reference(sums, big))
        n += data.n_big
    parts.append(inc_t.new_zeros((*lead, data.t_space - n)))
    return data.t_out(torch.cat(parts, dim=-1))


def test_txp_tail_keeps_the_old_composition_bits(v4_data):
    data = v4_data
    rng = np.random.default_rng(8)
    n = data.p_a.n_src * data.p_a.chunk_rows * 128
    for dtype in (torch.float32, torch.float64):
        for shape in ((n,), (3, n)):
            inc = torch.as_tensor(rng.random(shape), dtype=dtype)
            got = tv4._txp_tail(data, inc)
            assert got.shape == (*shape[:-1], data.t_space)
            assert torch.equal(got, old_tail(data, inc)), (dtype, shape)
    # and the kernel's work split on this layout's plan
    x = rng.random((1, n)).astype(np.float32)
    np.testing.assert_array_equal(
        emulate(x, data.tail_plan, rng),
        trs.row_sums(torch.from_numpy(x), data.tail_plan).numpy())


def test_malformed_second_levels_are_refused():
    table = trs.segment_table(np.arange(7), 0, "cpu")
    for n_out, first, offsets in (
        (None, 4, [1, 3]),           # offsets start at 0
        (None, 2, [0, 0, 3]),        # a group of no rows
        (None, 2, [0, 5]),           # rows past the table's outputs
        (3, 2, [0, 1, 2]),           # no room for the group sums
        (None, 9, [0]),              # first past the table's outputs
    ):
        with pytest.raises(ValueError):
            trs.RowSumPlan.make(table, n_out, first, np.array(offsets))


@pytest.mark.cuda
def test_tail_kernel_matches_plain_version_on_the_card():
    """One launch (both levels, the zero tail) bit-equal to the plain
    version at 1, 3 and 8 replicates, f32 and f64, each launched twice
    and after another batch, so that an arrival counter left set would
    show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(10)
    plan, n = random_plan(rng, [1, 33, 1100, 7])
    plan = trs.RowSumPlan.make(
        trs.RowSumTable.make(plan.table.entries, plan.table.n_out, "cuda"),
        plan.n_out, plan.first, plan.offsets)
    for dtype in (torch.float32, torch.float64):
        for B in (1, 3, 8, 1, 8, 3):
            x = torch.as_tensor(rng.random((B, n)), dtype=dtype,
                                device="cuda")
            want = trs.plan_reference(x.cpu(), plan)
            for _ in range(2):
                before = trace.counter("launch.row_sums")
                got = trs.row_sums(x if B > 1 else x[0], plan)
                torch.cuda.synchronize()
                assert trace.counter("launch.row_sums") == before + 1
                assert torch.equal(got.cpu(), want if B > 1 else want[0]), (
                    dtype, B)
