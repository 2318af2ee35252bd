"""Persistent v4 routing-plan cache.

Counterpart of the JAX package's `ops/plan_cache.py` (its structural cache;
the speculative prefetch during the pack, the BAM pointer files and the
shape-class envelopes are not ported). The directory is this package's
own, never the JAX package's: the entries hold the same tables but are
assembled for another framework.

The v4 layout + route tables are a pure function of the CSR STRUCTURE
(`txp_id`, `boundaries`, `num_txps`); per-alignment weights only enter at
the final `w_txp` fill. Building them costs seconds at transcriptome scale,
so re-quantifying the same alignments with different EM options, bootstrap
counts or output surfaces should not pay it twice. The key hashes the
POST-filter CSR, so any change that alters the retained alignments changes
the key.

key = blake2b over the structure bytes + format version; value = the
host-side layout products and the nine int8 routing tables per route,
pickled. On a hit the build reduces to one `w_txp` scatter + device
transfers.

Cache location: `$OARFISH_PLAN_CACHE_DIR` or
`~/.cache/oarfish_tpu_torch/plans`; disable with `OARFISH_PLAN_CACHE=0`.
Total size is capped (`OARFISH_PLAN_CACHE_GB`, default 4) with
oldest-first eviction.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("oarfish_tpu_torch")

VERSION = 1

# lay fields the cached finish needs (everything except the A-sized
# slot_of_aln, which only the route build consumes, and the weights)
_LAY_FIELDS = (
    "txp_slot_of_aln", "read_order", "big_row_of_txp", "big_row_offsets",
    "read_shapes", "read_starts", "n_slots_r", "row_space_r",
    "small_shapes", "small_starts", "row_space_s", "big_rows_pad",
    "n_big", "n_slots_t", "t_space", "num_reads", "num_txps",
    "t_perm_in", "t_perm_out", "t_rows",
)


def enabled() -> bool:
    return os.environ.get("OARFISH_PLAN_CACHE", "1") != "0"


def cache_dir() -> Path:
    d = os.environ.get("OARFISH_PLAN_CACHE_DIR")
    if d:
        return Path(d)
    return Path.home() / ".cache" / "oarfish_tpu_torch" / "plans"


def layout_key(txp_id: np.ndarray, boundaries: np.ndarray,
               num_txps: int) -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(f"v{VERSION};T={num_txps};".encode())
    t = np.ascontiguousarray(txp_id)
    b = np.ascontiguousarray(boundaries)
    h.update(str(t.dtype).encode())
    h.update(t.tobytes())
    h.update(str(b.dtype).encode())
    h.update(b.tobytes())
    return h.hexdigest()


def load(key: str) -> Optional[dict]:
    """The entry this program stored under `key`, or None."""
    p = cache_dir() / f"{key}.plan"
    try:
        with open(p, "rb") as fh:
            payload = pickle.load(fh)
        if payload.get("version") != VERSION:
            return None
        os.utime(p)  # LRU touch
        return payload
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 - a corrupt entry is a miss
        log.warning("plan cache entry %s unreadable (%s); rebuilding",
                    p.name, e)
        try:
            p.unlink()
        except OSError:
            pass
        return None


def _evict(budget_bytes: int, incoming: int) -> None:
    d = cache_dir()
    try:
        entries = sorted(
            ((p.stat().st_mtime, p.stat().st_size, p)
             for p in d.glob("*.plan")),
        )
    except OSError:
        return
    total = sum(s for _, s, _ in entries) + incoming
    for _, size, p in entries:
        if total <= budget_bytes:
            break
        try:
            p.unlink()
            total -= size
        except OSError:
            pass


# store threads not yet joined (`wait_for_stores`)
_pending: list = []


def store_async(key: str, payload: dict) -> threading.Thread:
    """Serialize + write on a background thread (the payload is already
    host-resident; pickling hundreds of MB costs about a second that stays
    off the run's critical path). Returns the thread, for callers that
    must see the entry on disk."""

    def write():
        try:
            d = cache_dir()
            d.mkdir(parents=True, exist_ok=True)
            payload["version"] = VERSION
            blob = pickle.dumps(payload, protocol=5)
            budget = int(
                float(os.environ.get("OARFISH_PLAN_CACHE_GB", "4")) * 1e9
            )
            _evict(budget, len(blob))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, d / f"{key}.plan")
        except Exception as e:  # noqa: BLE001 - cache is best-effort
            log.warning("plan cache store failed: %s", e)

    th = threading.Thread(target=write, daemon=True)
    th.start()
    _pending.append(th)
    return th


def wait_for_stores() -> None:
    """Join every store started by this process."""
    while _pending:
        _pending.pop().join()


def payload_from_build(lay: dict, routes_host: Tuple[dict, dict],
                       seg_id: Optional[np.ndarray]) -> dict:
    return {
        "lay": {k: lay[k] for k in _LAY_FIELDS},
        "routes": routes_host,
        "seg_id": seg_id,
    }


def finish_from_cache(payload: dict, weights: np.ndarray,
                      dtype: torch.dtype, device: torch.device):
    """Reassemble (EmV4Data, read_order) from a cache hit + this run's
    weights: `em_v4._v4_finish` minus the route build."""
    from .em_v4 import LANES, _device_parts, _w_txp, assemble
    from .static_permute import GlobalRoutePlan, tables_to_device

    lay = payload["lay"]

    def plan(h):
        (n_in, n_out, n_src, n_dst, Q, R1, R3, CR) = h["meta"]
        return GlobalRoutePlan(
            *tables_to_device(h["tables"], device),
            n_in=n_in, n_out=n_out, n_src=n_src, n_dst=n_dst,
            Q=Q, R1=R1, R3=R3, chunk_rows=CR,
        )

    p_a, p_b = (plan(h) for h in payload["routes"])
    w_txp = _w_txp(lay["txp_slot_of_aln"], weights,
                   p_a.n_src * p_a.chunk_rows * LANES)
    parts = _device_parts(lay, payload["seg_id"], w_txp, dtype, device)
    return assemble(lay, p_a, p_b, parts), lay["read_order"]
