"""State carried across from the JAX package.

The fields of the JAX package's `EmData` (the JAX package's `ops/em.py`),
`FastEmData` (the JAX package's `ops/em_fast.py`), `SortedGatherPlan`
(the JAX package's `ops/gather_pallas.py`) and `EmV4Data` with its
`GlobalRoutePlan`s and `BatchTilePermute`s (the JAX package's
`ops/em_v4.py`, `ops/static_permute.py`) come in as NumPy arrays plus the
meta integers and go out as this package's dataclasses on a given device,
so both packages can run on identical tables. So do the sharded states:
`ShardedCsr` (the JAX package's `parallel/sharded_em.py`) through
`sharded_csr_from_numpy` and the stacked `ShardedV4.data` (the JAX
package's `parallel/sharded_v4.py`) through `sharded_v4_from_jax`. This
package's own `build` functions produce the same arrays.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .em import EmData, csr_offsets
from .em_fast import FastEmData, offset_tables
from .em_v4 import EmV4Data, row_sources
from .sorted_gather import SortedGatherPlan, pack_code
from .static_permute import ROUTE_TABLES, BatchTilePermute, GlobalRoutePlan


def _tensor(a, device, dtype=None) -> torch.Tensor:
    # np.array copies: arrays exported by JAX are read-only
    t = torch.as_tensor(np.array(a), device=device)
    return t if dtype is None else t.to(dtype)


def _base_rows(base: np.ndarray) -> np.ndarray:
    """The JAX kernel reads `base` as a `[n_rows, 128]` tile (lane 0); the
    CUDA kernel takes `[n_rows]`."""
    base = np.asarray(base)
    return base[:, 0] if base.ndim == 2 else base


def em_data_from_numpy(
    txp_id, weights, read_id, txp_sort_perm, txp_id_sorted,
    num_reads: int, num_txps: int, dtype: torch.dtype, device,
) -> EmData:
    return EmData(
        txp_id=_tensor(txp_id, device, torch.int32),
        weights=_tensor(weights, device, dtype),
        read_id=_tensor(read_id, device, torch.int32),
        txp_sort_perm=_tensor(txp_sort_perm, device, torch.int32),
        txp_id_sorted=_tensor(txp_id_sorted, device, torch.int32),
        read_offsets=_tensor(
            csr_offsets(np.asarray(read_id), int(num_reads)), device
        ),
        txp_offsets=_tensor(
            csr_offsets(np.asarray(txp_id_sorted), int(num_txps)), device
        ),
        num_reads=int(num_reads),
        num_txps=int(num_txps),
    )


def gather_plan_from_numpy(
    base, lane, use_hi, src_pos, n_rows: int, table_rows: int, out_len: int,
    device,
) -> SortedGatherPlan:
    return SortedGatherPlan(
        base=_tensor(_base_rows(base), device, torch.int32),
        code=_tensor(pack_code(lane, use_hi), device),
        src_pos=np.asarray(src_pos, dtype=np.int64),
        n_rows=int(n_rows),
        table_rows=int(table_rows),
        out_len=int(out_len),
    )


def fast_em_data_from_numpy(
    bucket_txp: Sequence, bucket_w: Sequence, txp_csc, w_csc, read_csc,
    txp_offsets, g_p0: Optional[np.ndarray], g_lane: Optional[np.ndarray],
    g_hi: Optional[np.ndarray], bucket_rows: Sequence[int], num_reads: int,
    num_txps: int, num_tiles: int, g_rows: int, g_table_rows: int,
    use_pallas_gather: bool, dtype: torch.dtype, device,
) -> FastEmData:
    """`g_p0` may be the JAX package's `[g_rows, 128]` broadcast or the
    `[g_rows]` vector; its unused `g_p1` has no counterpart here."""
    has_plan = bool(use_pallas_gather)
    offsets = _tensor(txp_offsets, device, torch.int64)
    off_tile, off_prev, off_inner = offset_tables(offsets)
    return FastEmData(
        bucket_txp=tuple(_tensor(t, device, torch.int32) for t in bucket_txp),
        bucket_w=tuple(_tensor(w, device, dtype) for w in bucket_w),
        txp_csc=_tensor(txp_csc, device, torch.int32),
        w_csc=_tensor(w_csc, device, dtype),
        read_csc=_tensor(read_csc, device, torch.int32),
        txp_offsets=offsets,
        off_tile=off_tile,
        off_prev=off_prev,
        off_inner=off_inner,
        g_p0=(_tensor(_base_rows(g_p0), device, torch.int32)
              if has_plan else None),
        g_code=(_tensor(pack_code(g_lane, g_hi), device)
                if has_plan else None),
        bucket_rows=tuple(int(r) for r in bucket_rows),
        num_reads=int(num_reads),
        num_txps=int(num_txps),
        num_tiles=int(num_tiles),
        g_rows=int(g_rows),
        g_table_rows=int(g_table_rows),
        use_pallas_gather=has_plan,
    )


ROUTE_META = ("n_in", "n_out", "n_src", "n_dst", "Q", "R1", "R3",
              "chunk_rows")
V4_META = ("read_shapes", "read_starts", "n_slots_r", "row_space_r",
           "small_shapes", "small_starts", "row_space_s", "big_rows_pad",
           "n_big", "n_slots_t", "t_space", "num_reads", "num_txps")


def route_plan_from_numpy(fields: Mapping, device) -> GlobalRoutePlan:
    """`fields` holds the nine int8 tables under the names of
    `ROUTE_TABLES` (`s1_src` may be None) and the integers of
    `ROUTE_META`."""
    tables = {
        name: None if fields[name] is None
        else _tensor(fields[name], device, torch.int8)
        for name in ROUTE_TABLES
    }
    return GlobalRoutePlan(
        **tables, **{k: int(fields[k]) for k in ROUTE_META})


def tile_permute_from_numpy(fields: Mapping, device) -> BatchTilePermute:
    """`fields` holds `r1`, `r2`, `src`, `lane` (int8) and `rows`,
    `n_tiles`."""
    return BatchTilePermute(
        **{k: _tensor(fields[k], device, torch.int8)
           for k in ("r1", "r2", "src", "lane")},
        rows=int(fields["rows"]), n_tiles=int(fields["n_tiles"]),
    )


def v4_data_from_jax(
    w_txp, p_a: Mapping, p_b: Mapping, t_in: Mapping, t_out: Mapping,
    big_row_of_txp, big_row_offsets, seg_id: Optional[np.ndarray],
    meta: Mapping, dtype: torch.dtype, device,
) -> EmV4Data:
    """The routed EM's device state from the fields of the JAX package's
    `EmV4Data`: `p_a` / `p_b` as `route_plan_from_numpy` takes them, `t_in`
    / `t_out` as `tile_permute_from_numpy` does, `meta` the static
    integers and tuples of `V4_META`."""
    def shapes(v):
        return tuple(tuple(int(x) for x in s) for s in v)

    static = {k: meta[k] for k in V4_META}
    for k in ("read_shapes", "small_shapes"):
        static[k] = shapes(static[k])
    for k in ("read_starts", "small_starts"):
        static[k] = tuple(int(x) for x in static[k])
    route_a = route_plan_from_numpy(p_a, device)
    return EmV4Data(
        w_txp=_tensor(w_txp, device, dtype),
        p_a=route_a,
        p_b=route_plan_from_numpy(p_b, device),
        **row_sources(static, route_a, device),
        t_in=tile_permute_from_numpy(t_in, device),
        t_out=tile_permute_from_numpy(t_out, device),
        big_row_of_txp=_tensor(big_row_of_txp, device, torch.int64),
        big_row_offsets=_tensor(big_row_offsets, device, torch.int64),
        seg_id=(None if seg_id is None
                else _tensor(seg_id, device, torch.int8)),
        **static,
    )


SHARDED_CSR_ARRAYS = ("txp_id", "weights", "read_id", "txp_sort_perm",
                      "txp_id_sorted", "shard_num_reads")


def sharded_csr_from_numpy(fields: Mapping, read_ranges, num_txps: int,
                           num_reads: int, r_pad: int):
    """The port's `ShardedCsr` from the JAX package's: `fields` holds the
    `[D, ...]` arrays of `SHARDED_CSR_ARRAYS`."""
    from ..parallel.sharded_em import ShardedCsr

    sh = ShardedCsr.__new__(ShardedCsr)
    for k in SHARDED_CSR_ARRAYS:
        setattr(sh, k, np.array(fields[k]))
    sh.read_ranges = [tuple(int(x) for x in r) for r in read_ranges]
    sh.num_shards = len(sh.read_ranges)
    sh.num_txps, sh.num_reads = int(num_txps), int(num_reads)
    sh.a_pad = sh.txp_id.shape[1]
    sh.r_pad = int(r_pad)
    return sh


def sharded_v4_from_jax(
    w_txp, p_a: Mapping, p_b: Mapping, t_in: Mapping, t_out: Mapping,
    big_row_of_txp, big_row_offsets, seg_id: Optional[np.ndarray],
    meta: Mapping, read_ranges, read_orders, dtype: torch.dtype, devices,
):
    """The port's `ShardedV4` from the JAX package's: every array argument
    is the stacked field of its `data` (leading shard axis), the mappings as
    `v4_data_from_jax` takes them with stacked tables; shard d goes to
    `devices[d]`."""
    from ..parallel.sharded_v4 import ShardedV4

    def at(x, d):
        if isinstance(x, Mapping):
            return {k: at(v, d) for k, v in x.items()}
        return x[d] if isinstance(x, np.ndarray) else x

    datas = [
        v4_data_from_jax(
            at(w_txp, d), at(p_a, d), at(p_b, d), at(t_in, d), at(t_out, d),
            at(big_row_of_txp, d), at(big_row_offsets, d),
            None if seg_id is None else seg_id[d], meta, dtype, dev,
        )
        for d, dev in enumerate(devices)
    ]
    return ShardedV4.of_shards(datas, read_ranges, read_orders)
