"""Persistent v4 routing-plan cache.

Counterpart of the JAX package's `ops/plan_cache.py`: the structural
cache, the BAM pointer files and the prefetch during the pack (the
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

A BAM pointer file (`<pointer key>.ptr`, the key hashing the BAM's path,
size and mtime and the filter settings that change the kept alignments)
names the structural key its last run used. The next run of that BAM
reads the entry on a worker thread while the pack streams (`Prefetch`);
the entry is used only if the packed CSR's own key matches.

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


def store_async(key: str, payload: dict,
                pointer_key: Optional[str] = None) -> threading.Thread:
    """Serialize + write on a background thread (the payload is already
    host-resident; pickling hundreds of MB costs about a second that stays
    off the run's critical path). Returns the thread, for callers that
    must see the entry on disk. The BAM pointer, when given, is written
    only after the entry has been renamed into place: a pointer to an
    entry not yet written would make the next run's prefetch miss."""

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
            if pointer_key is not None:
                write_pointer(pointer_key, key)
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


# ---------------------------------------------------------------------------
# Prefetch during the pack. The pointer key is the BAM's file identity
# (realpath, size, mtime) and the filter fingerprint: a hint only; the
# structural key of the packed CSR decides before the entry is used.
# ---------------------------------------------------------------------------


def bam_pointer_key(path, fingerprint: str) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    h = hashlib.blake2b(digest_size=20)
    h.update(
        f"ptr{VERSION};{os.path.realpath(path)};{st.st_size};"
        f"{st.st_mtime_ns};{fingerprint}".encode()
    )
    return h.hexdigest()


def read_pointer(ptr_key: str) -> Optional[str]:
    try:
        return (cache_dir() / f"{ptr_key}.ptr").read_text().strip()
    except OSError:
        return None


def write_pointer(ptr_key: str, structural_key: str) -> None:
    try:
        d = cache_dir()
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{ptr_key}.ptr").write_text(structural_key)
    except OSError as e:
        log.warning("plan cache pointer write failed: %s", e)


class Prefetch:
    """Reads a cached plan on a worker thread while the pack streams.

    The thread only unpickles and checks the entry (host work: hundreds of
    MB read off the run's critical path). The tables go to the device in
    `finish`, on the caller's thread and stream, after the structural key
    of the packed CSR has been checked: no CUDA work runs on the worker,
    so no stream or event has to order it against the run's own work, and
    the copies (a few hundred MB over PCIe) are a small part of a hit."""

    def __init__(self, structural_key: str):
        self.key = structural_key
        self._res: dict = {}
        self._th = threading.Thread(target=self._load, daemon=True)
        self._th.start()

    def _load(self):
        try:
            payload = load(self.key)
            if payload is None:
                raise FileNotFoundError(
                    f"plan entry {self.key[:12]}... vanished before prefetch"
                )
            self._res["payload"] = payload
        except BaseException as e:  # noqa: BLE001 - a miss at finish
            self._res["err"] = e

    def status(self) -> str:
        """Non-blocking: 'pending' while the worker reads, 'ok' once the
        entry is unpickled and its version checked, 'failed' on any error.
        Lets the caller keep its hedge (the V4Prebuild) alive exactly until
        the entry is known to be readable."""
        if self._th.is_alive():
            return "pending"
        return "failed" if "err" in self._res else "ok"

    def finish(self, structural_key: str, weights: np.ndarray,
               dtype: torch.dtype, device: torch.device):
        """(EmV4Data, read_order) from the entry and this run's weights, or
        None when the key does not match or the read failed (the caller
        then takes the ordinary cache lookup or builds)."""
        self._th.join()
        if "err" in self._res:
            log.warning("plan prefetch failed: %s", self._res["err"])
            return None
        if structural_key != self.key:
            log.info("plan prefetch pointer was stale (CSR changed); "
                     "ignoring it")
            return None
        try:
            return finish_from_cache(self._res["payload"], weights, dtype,
                                     device)
        except (KeyError, ValueError, TypeError) as e:
            log.warning("prefetched plan entry unusable (%s); rebuilding", e)
            return None


def prefetch_for_bam(path, fingerprint: str) -> Optional[Prefetch]:
    """Start reading the plan this BAM and filter set used last time;
    None when there is no pointer or no entry."""
    if not enabled():
        return None
    ptr = bam_pointer_key(path, fingerprint)
    if ptr is None:
        return None
    skey = read_pointer(ptr)
    if skey is None:
        return None
    if not (cache_dir() / f"{skey}.plan").exists():  # cheap existence probe
        return None
    log.info("plan cache: prefetching %s... during the pack", skey[:12])
    return Prefetch(skey)
