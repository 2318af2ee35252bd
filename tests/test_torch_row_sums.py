"""The fixed-order row sums of the routed EM's glue (`ops/row_sums.py`).

On the CPU the plain version is held bit for bit against the JAX
package's bucket row sums (`oarfish_tpu/ops/em_v4.py::_row_sums`, XLA's
reduction) on bucket layouts with the power-of-two widths of the v4
layout, with gaps between buckets and a tail, f32 and f64; every
replicate of a batch gets the bits it gets alone; the second level
(consecutive runs, `segment_table`) follows the kernel's order, emulated
here one addition at a time; malformed tables are refused. On the card
(`cuda`) the kernel is bit-equal to its plain version, alone and at 8
replicates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops.em_v4 import _row_sums as jax_row_sums
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops import row_sums as trs
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


def test_v4_layout_tables():
    """An `EmV4Data`'s tables read what the glue hands them: the
    transcript layout's slots, its row sums for the big region's second
    level, the read layout's slots."""
    rng = np.random.default_rng(5)
    R, T = 20_000, 300
    sizes = rng.geometric(1 / 3, size=R).clip(1, 30)
    boundaries = np.concatenate([[0], np.cumsum(sizes)])
    txp_id = (rng.zipf(1.3, size=int(boundaries[-1])) % T).astype(np.int32)
    data, _ = tv4.EmV4Data.build(txp_id, np.ones(len(txp_id)), boundaries, T,
                                 device="cpu")
    n_t = data.p_a.n_src * data.p_a.chunk_rows * 128
    assert data.txp_sum_table.n_in <= n_t
    assert data.txp_sum_table.n_out == data.row_space_s + data.big_rows_pad
    assert data.read_sum_table.n_out == data.row_space_r
    assert data.big_sum_table.n_out == data.n_big > 0
    assert data.big_sum_table.n_in <= data.txp_sum_table.n_out


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
        before = trs.launch_count
        got = trs.row_sums(x, table)
        torch.cuda.synchronize()
        assert trs.launch_count == before + 1
        assert torch.equal(got.cpu(), trs.row_sums_reference(x.cpu(), table))
