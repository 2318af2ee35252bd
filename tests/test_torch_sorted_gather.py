"""Sorted gather of the torch port vs the Pallas kernel of the JAX package.

The same seeded NumPy inputs go through `gather_pallas.sorted_gather`
(Pallas interpret mode on the CPU) and through the port's plain version,
which is what the port runs for CPU tensors and what the CUDA kernel is
held against on the card.

The port's plan carries one byte an element (`code = lane | use_hi << 7`)
and reads the table flat, `[n]` or `[B, n]`, with no copy padded to
`S*128`: the tables here have lengths that are not multiples of 128, as
the EM's `T + 1` is not.

Tolerances: an f32 table must come out bit for bit (the kernel moves
values, it does no arithmetic on them). For an f64 table the Pallas
kernel returns f32 (its delivery runs on f32 one-hot products) while the
port passes f64 through exactly, so the two agree to f32 rounding:
rtol 1e-6. Slots that pad a real row repeat the row's first value in
both packages; whole pad rows are 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import gather_pallas as jg
from oarfish_tpu_torch.ops import sorted_gather as tg
from oarfish_tpu_torch.ops.convert import gather_plan_from_numpy
from oarfish_tpu_torch.utils import trace
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

CASES = [
    # seed, table_size, n_idx
    (0, 1000, 5000),
    (1, 5000, 3000),     # sparser than one index per entry: short rows
    (2, 129, 700),       # two table rows
    (3, 40000, 2000),    # very sparse: many one-element rows
    (4, 300, 1),
    (5, 1024, 3000),     # a multiple of 128: no slack after the last row
]


def make_case(seed, table_size, n_idx):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, table_size, size=n_idx)).astype(np.int64)
    table = rng.normal(size=table_size)
    return idx, table


def jax_plan_to_port(plan):
    return gather_plan_from_numpy(
        plan.base, np.asarray(plan.lane), np.asarray(plan.use_hi),
        plan.src_pos, plan.n_rows, plan.table_rows, plan.out_len, "cpu",
    )


@pytest.mark.parametrize("seed,table_size,n_idx", CASES)
def test_plan_build_equals_jax(seed, table_size, n_idx):
    idx, _ = make_case(seed, table_size, n_idx)
    jp = jg.SortedGatherPlan.build(idx, table_size)
    tp = tg.SortedGatherPlan.build(idx, table_size, device="cpu")
    assert (tp.n_rows, tp.table_rows, tp.out_len) == (
        jp.n_rows, jp.table_rows, jp.out_len)
    np.testing.assert_array_equal(tp.base.numpy(), jp.base)
    lane, use_hi = tg.unpack_code(tp.code)
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jp.lane))
    np.testing.assert_array_equal(use_hi.numpy().astype(bool),
                                  np.asarray(jp.use_hi))
    np.testing.assert_array_equal(tp.src_pos, jp.src_pos)
    assert tp.base.dtype == torch.int32 and tp.code.dtype == torch.uint8
    assert tuple(tp.code.shape) == (tp.n_rows, 128)
    # the JAX plan carried across packs to the same codes
    assert torch.equal(jax_plan_to_port(jp).code, tp.code)


@pytest.mark.parametrize("seed,table_size,n_idx", CASES)
def test_f32_bit_equal_to_pallas(seed, table_size, n_idx):
    idx, table = make_case(seed, table_size, n_idx)
    table = table.astype(np.float32)
    jp = jg.SortedGatherPlan.build(idx, table_size)
    want = np.asarray(jg.sorted_gather(jnp.asarray(table), jp))
    # once on the port's own plan, once on the JAX plan carried across
    for plan in (tg.SortedGatherPlan.build(idx, table_size, device="cpu"),
                 jax_plan_to_port(jp)):
        got = tg.sorted_gather(torch.from_numpy(table), plan)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
        ref = tg.sorted_gather_reference(torch.from_numpy(table), plan)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("seed,table_size,n_idx", CASES)
def test_f64_close_to_pallas_and_exact(seed, table_size, n_idx):
    idx, table = make_case(seed, table_size, n_idx)
    jp = jg.SortedGatherPlan.build(idx, table_size)
    want = np.asarray(jg.sorted_gather(jnp.asarray(table), jp))
    plan = tg.SortedGatherPlan.build(idx, table_size, device="cpu")
    got = tg.sorted_gather(torch.from_numpy(table), plan)
    assert got.dtype == torch.float64  # the port keeps the table's type
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # and it is table[idx] exactly; pad rows (base < 0) are 0
    mask = plan.src_pos >= 0
    np.testing.assert_array_equal(
        got.numpy()[mask], table[idx[plan.src_pos[mask]]])
    pad_rows = plan.base.numpy() < 0
    assert not mask.reshape(-1, 128)[pad_rows].any()
    assert not got.numpy().reshape(-1, 128)[pad_rows].any()


@pytest.mark.parametrize("seed,table_size,n_idx", CASES[:3])
def test_replicate_axis(seed, table_size, n_idx):
    idx, _ = make_case(seed, table_size, n_idx)
    rng = np.random.default_rng(100 + seed)
    tables = torch.from_numpy(rng.normal(size=(5, table_size)))
    plan = tg.SortedGatherPlan.build(idx, table_size, device="cpu")
    got = tg.sorted_gather(tables, plan)
    assert got.shape == (5, plan.out_len)
    for b in range(5):
        assert torch.equal(got[b], tg.sorted_gather(tables[b], plan))


def codes(lane, use_hi):
    return torch.from_numpy(tg.pack_code(lane, use_hi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [None, 2])
def test_pad_rows_and_out_of_range_rows_give_zero(dtype, batch):
    # base = -2 (pad row), base + use_hi == S (past the table) and
    # base = -1 with use_hi = 0 (row -1) are 0; base = -1 keeps its
    # elements in row 0
    S = 8
    n = S * 128
    shape = (n,) if batch is None else (batch, n)
    table = torch.arange(1, n * (batch or 1) + 1, dtype=dtype).reshape(shape)
    base = torch.tensor([-2, S - 1, 0, -1], dtype=torch.int32)
    lane = np.zeros((4, 128), dtype=np.int64)
    lane[:, 1] = 5
    use_hi = np.zeros((4, 128), dtype=np.uint8)
    use_hi[1, 1] = 1  # row S: outside
    use_hi[2, 1] = 1
    use_hi[3, 1:] = 1  # row 0; element 0 stays in row -1
    out = tg.gather_rows(table, base, codes(lane, use_hi), S)
    assert out.shape == (*shape[:-1], 4, 128) and out.dtype == dtype
    t2d = table.reshape(*shape[:-1], S, 128)
    assert not out[..., 0, :].any()
    assert torch.equal(out[..., 1, 0], t2d[..., S - 1, 0])
    assert not out[..., 1, 1].any()
    assert torch.equal(out[..., 2, 0], t2d[..., 0, 0])
    assert torch.equal(out[..., 2, 1], t2d[..., 1, 5])
    assert not out[..., 3, 0].any()
    assert torch.equal(out[..., 3, 1], t2d[..., 0, 5])
    assert torch.equal(out[..., 3, 2:], t2d[..., 0, :1].expand_as(
        out[..., 3, 2:]))


@pytest.mark.parametrize("n", [1000, 1025, 1151])
def test_index_at_or_past_the_table_length_gives_zero(n):
    # S = 16 rows of 128 hold n < S*128 entries; the last real row's
    # elements at or past n read 0, as they do from the JAX package's
    # zero-padded [S, 128] table
    S = 16
    table = torch.from_numpy(np.random.default_rng(n).normal(size=n))
    last = (n - 1) // 128
    base = torch.tensor([last, last - 1], dtype=torch.int32)
    lane = np.tile(np.arange(128), (2, 1))
    use_hi = np.zeros((2, 128), dtype=np.uint8)
    use_hi[1] = 1
    out = tg.gather_rows(table, base, codes(lane, use_hi), S)
    padded = torch.nn.functional.pad(table, (0, S * 128 - n))
    for r in range(2):
        idx = last * 128 + torch.arange(128)
        assert torch.equal(out[r], padded[idx])
        assert not out[r][idx >= n].any()
        assert torch.equal(out[r][idx < n], table[idx[idx < n]])


def test_empty_index():
    plan = tg.SortedGatherPlan.build(np.empty(0, np.int64), 100, device="cpu")
    assert plan.n_rows == 0 and plan.out_len == 0
    out = tg.sorted_gather(torch.zeros(100), plan)
    assert out.shape == (0,)


def test_table_larger_than_plan_raises():
    plan = tg.SortedGatherPlan.build(np.arange(10), 100, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tg.sorted_gather(torch.zeros(plan.table_rows * 128 + 1), plan)


def test_cuda_wrapper_refuses_cpu_tensors():
    plan = tg.SortedGatherPlan.build(np.arange(10), 100, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tg.gather_rows_cuda(torch.zeros(100), plan.base, plan.code,
                            plan.table_rows)


@pytest.mark.parametrize("fn", ["gather_rows", "gather_rows_reference"])
@pytest.mark.parametrize("case", ["int32 lane", "table past S*128"])
def test_wrapper_refuses(fn, case):
    plan = tg.SortedGatherPlan.build(np.arange(10), 100, device="cpu")
    table, code = torch.zeros(100), plan.code
    if case == "int32 lane":  # the old plan's lane is not a code
        code = tg.unpack_code(plan.code)[0].int()
        err, match = TypeError, "uint8"
    else:
        table = torch.zeros(plan.table_rows * 128 + 1)
        err, match = ValueError, "does not fit"
    with pytest.raises(err, match=match):
        getattr(tg, fn)(table, plan.base, code, plan.table_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [None, 3])
def test_kernel_bit_equal_to_plain_on_card(dtype, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    idx, _ = make_case(0, 50_000, 200_000)
    rng = np.random.default_rng(5)
    shape = (50_000,) if batch is None else (batch, 50_000)
    table = torch.from_numpy(rng.normal(size=shape)).to(dtype).cuda()
    plan = tg.SortedGatherPlan.build(idx, 50_000, device="cuda")
    before = trace.counter("launch.sorted_gather")
    got = tg.sorted_gather(table, plan)
    torch.cuda.synchronize()
    assert trace.counter("launch.sorted_gather") == before + 1
    assert torch.equal(got, tg.sorted_gather_reference(table, plan))
    # wrong dtype / layout raise instead of running something else
    with pytest.raises(TypeError):
        tg.sorted_gather(table.half(), plan)
    with pytest.raises(ValueError):
        tg.gather_rows_cuda(table, plan.base, plan.code.t().contiguous().t(),
                            plan.table_rows)
    with pytest.raises(TypeError):  # an int32 lane is not a code
        tg.gather_rows_cuda(table, plan.base,
                            tg.unpack_code(plan.code)[0].int(),
                            plan.table_rows)
    with pytest.raises(ValueError, match="does not fit"):
        tg.gather_rows_cuda(torch.nn.functional.pad(
            table, (0, plan.table_rows * 128 + 1 - 50_000)), plan.base,
            plan.code, plan.table_rows)
