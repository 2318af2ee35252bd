"""Device coverage model: logistic per-bin probabilities and the per-read
coverage normalization as segment operations over the flat bin CSR.

Counterpart of the JAX package's `models/coverage_jax.py`; the semantics are
those of `logistic_probability.rs:40-79` and
`normalize_probability.rs:5-74`, and the NumPy functions of `coverage.py`
(`logistic_prob_np`, `normalize_read_probs_np`) are the oracle. All
arithmetic is f64 on the device the caller names (default: `cuda`). The
module has no kernel of its own: plain torch on the device takes the place
of plain `jnp`.

Every reduction is deterministic: per-transcript and per-read sums go
through `torch.segment_reduce` over the bin offsets and the read
boundaries (one thread adds a segment in index order); there is no
`index_add_` and no float atomic.

The interior sum of an alignment's bins is a difference of two prefix
sums over the whole flat array, as in the host passes. Those prefix sums
reach 10^6 at a full transcriptome, so the difference keeps only what the
prefix sums' rounding leaves, and a parallel scan rounds differently from
a serial one. The prefix sums are therefore NumPy's serial `cumsum` over
the flat array, which is on the host anyway between the two functions:
that reproduces the native host pass.

`quant/bulk.py` selects this module with `OARFISH_COVMODEL=torch`, as the
JAX package selects its device model with `=jax`; the native host pass of
`coverage.py` stays the default.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..host.store import AlignmentStore, TranscriptCoverage


def _segment_sum(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(x, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def logistic_prob_torch(
    cov: TranscriptCoverage, growth_rate: float, device=None
) -> np.ndarray:
    """Device `logistic_prob`; mutates `cov.bins` by the pseudo-count
    exactly like the host paths and returns the flat f64 probability
    array (host numpy)."""
    device = resolve_device(device)
    f64 = torch.float64
    offsets = torch.as_tensor(
        np.asarray(cov.bin_offsets, dtype=np.int64), device=device)
    nbins = offsets[1:] - offsets[:-1]
    T = nbins.shape[0]
    bins = torch.as_tensor(np.asarray(cov.bins, dtype=np.float64),
                           device=device)
    t_of_bin = torch.repeat_interleave(
        torch.arange(T, device=device), nbins, output_size=bins.shape[0])
    total_weight = torch.as_tensor(
        np.asarray(cov.total_weight, dtype=np.float64), device=device)
    # pseudo-count: total_weight/100 added to every bin
    bins2 = bins + (total_weight / 100.0).index_select(0, t_of_bin)
    counts64 = bins2.to(torch.float32).to(f64)
    count_sum = _segment_sum(counts64, offsets)
    expected = count_sum / nbins.to(f64)
    active = count_sum > 1e-8
    exp_b = expected.index_select(0, t_of_bin)
    diff = (exp_b - counts64) / exp_b
    v = 1.0 / (1.0 + torch.exp(-float(growth_rate) * diff))
    v = v.clamp(1e-8, 0.99999)
    out = torch.where(active.index_select(0, t_of_bin), v,
                      torch.zeros_like(v))
    cov.bins[:] = bins2.cpu().numpy()
    return out.cpu().numpy()


def normalize_read_probs_torch(
    store: AlignmentStore, cov: TranscriptCoverage,
    cov_prob_flat: np.ndarray, bin_width: int, device=None,
) -> None:
    """Device `normalize_read_probs`; fills `store.cov_prob`."""
    A = store.num_alignments
    if A == 0:
        return
    device = resolve_device(device)
    f64, i64 = torch.float64, torch.int64

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    flat_host = np.ascontiguousarray(cov_prob_flat, dtype=np.float64)
    flat = torch.as_tensor(flat_host, device=device)
    # serial prefix sums, taken on the host (module docstring)
    csum_host = np.empty(len(flat_host) + 1, dtype=np.float64)
    csum_host[0] = 0.0
    np.cumsum(flat_host, out=csum_host[1:])
    csum0 = torch.as_tensor(csum_host, device=device)
    tid = dev(store.txp_id, np.int64)
    start = dev(store.start, np.float64)
    end = dev(store.end, np.float64)
    boundaries = dev(store.boundaries, np.int64)
    bin_off = dev(cov.bin_offsets[:-1], np.int64)
    nbins = dev(cov.nbins, np.int64)
    lenf = dev(cov.lenf, np.float64)
    bl = float(bin_width)

    nb = nbins.index_select(0, tid)
    sb = (start / bl).to(i64)
    eb = torch.minimum((end / bl).to(i64), nb - 1)
    off = bin_off.index_select(0, tid)

    same = sb == eb
    # single-bin: expected = cp (w != 0) else NaN, as the reference's 0/0
    w_same = (end - start) / bl
    # every index below is in range for a valid store; the clamps keep a
    # stray one from faulting the device
    hi = flat.shape[0]
    cp_same = flat.index_select(0, (off + sb).clamp(0, hi - 1))
    exp_same = torch.where(w_same != 0.0, cp_same,
                           torch.full_like(cp_same, torch.nan))
    # multi-bin: fractional first bin + interior prefix-sum difference,
    # the end bin excluded
    a = off + sb + 1
    b = off + eb
    n_interior = (b - a).to(f64).clamp_min(0.0)
    interior = torch.where(
        a < b,
        csum0.index_select(0, b.clamp(0, hi))
        - csum0.index_select(0, a.clamp(0, hi)),
        torch.zeros_like(w_same))
    bin_end_first = torch.minimum(bl * sb.to(f64) + bl,
                                  lenf.index_select(0, tid))
    w_first = (bin_end_first - start) / bl
    exp_multi = (w_first * cp_same + interior) / (w_first + n_interior)

    expected = torch.where(same, exp_same, exp_multi)
    if not bool(torch.isfinite(expected).all()):
        raise FloatingPointError(
            "invalid result in normalize_read_probs (NaN/inf coverage prob)"
        )
    # normalize within each read to sum 1 (sum <= 0 -> divide by 1)
    nsum = _segment_sum(expected, boundaries)
    denom = torch.where(nsum > 0.0, nsum, torch.ones_like(nsum))
    rid = torch.repeat_interleave(
        torch.arange(store.num_reads, device=device),
        boundaries[1:] - boundaries[:-1], output_size=A)
    store.cov_prob[:] = (expected / denom.index_select(0, rid)).cpu().numpy()
