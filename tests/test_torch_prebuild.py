"""The v4 host work that the torch port hides behind the pack (queue A8):
`em_v4.V4Prebuild`, the plan cache's BAM pointer files and `Prefetch`, and
the hedge between them in `quant/bulk.py`.

None of it may change a result:

* `V4Prebuild` fed a CSR in uneven chunks assembles the same inputs as the
  JAX package's `V4Prebuild` fed the same chunks, and `_v4_layout` with
  them is equal, array for array, to the layout built without them; a
  prebuild whose shape is not the CSR's is ignored.
* the pack's `chunk_observer` sees chunks that reassemble to the packed
  store.
* through the CLI (`--em-impl v4 --device cpu`, simulated BAMs on the
  golden transcripts, nothing read from outside the repository) a run
  that takes its plan from the pointer file's prefetch, a run whose
  prefetch reports `ok` (the prebuilder quietly aborted) or `failed` (the
  prebuilder kept), and a run with `OARFISH_PREBUILD=0` write the same
  `.quant`, `.ambig_info.tsv` and `.prob` bytes as a run without any of it.
"""

import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_v4 as jv4
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.config import FilterOpts
from oarfish_tpu_torch.host.packer import pack_bam_fast
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops import plan_cache
from oarfish_tpu_torch.quant import bulk as tbulk
from test_em import random_csr
from test_torch_bulk_e2e import golden_transcripts
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

R, T = 40_000, 2_000
OUTPUTS = (".quant", ".ambig_info.tsv", ".prob")


def skewed_csr(seed):
    rng = np.random.default_rng(seed)
    txp_id, w, boundaries, _, _, _ = random_csr(rng, R=R, T=T, max_k=6)
    txp_id = (rng.zipf(1.3, size=len(txp_id)) % T).astype(np.int32)
    return txp_id, w, boundaries


def feed(prebuild, txp_id, boundaries, cuts):
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        alo, ahi = boundaries[lo], boundaries[hi]
        prebuild.observe(SimpleNamespace(
            txp_id=txp_id[alo:ahi], boundaries=boundaries[lo:hi + 1] - alo))


def assert_same_layout(got, want):
    assert got.keys() == want.keys()
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(got[key], val, err_msg=key)
        else:
            assert got[key] == val, key


def test_prebuild_in_uneven_chunks_gives_the_monolithic_layout():
    txp_id, w, boundaries = skewed_csr(23)
    cuts = [0, 37, 10_001, 10_002, 25_000, R - 1, R]
    pb, jpb = tv4.V4Prebuild(), jv4.V4Prebuild()
    feed(pb, txp_id, boundaries, cuts)
    feed(jpb, txp_id, boundaries, cuts)
    pre, jpre = pb.finish(T), jpb.finish(T)
    assert pre is not None and (pre["A"], pre["R"]) == (len(txp_id), R)
    for k in ("counts", "rank", "max_size", "A", "R"):
        np.testing.assert_array_equal(pre[k], jpre[k], err_msg=k)
    assert pre["classes"].keys() == jpre["classes"].keys()
    for K in jpre["classes"]:
        np.testing.assert_array_equal(pre["classes"][K], jpre["classes"][K])
    mono = tv4._v4_layout(txp_id, w, boundaries, T)
    assert mono["n_big"] > 0  # the skew chunks hot transcripts over rows
    assert_same_layout(tv4._v4_layout(txp_id, w, boundaries, T, pre=pre),
                       mono)


def test_prebuild_of_another_shape_is_ignored(caplog):
    txp_id, w, boundaries = skewed_csr(5)
    pb = tv4.V4Prebuild()
    feed(pb, txp_id, boundaries, [0, 100])  # 100 reads of 40,000
    pre = pb.finish(T)
    with caplog.at_level(logging.WARNING, logger="oarfish_tpu_torch"):
        got = tv4._v4_layout(txp_id, w, boundaries, T, pre=pre)
    assert "v4 prebuild shape mismatch" in caplog.text
    assert_same_layout(got, tv4._v4_layout(txp_id, w, boundaries, T))


def test_aborted_prebuild_gives_none(caplog):
    pb = tv4.V4Prebuild()
    pb.abort(quiet=True)
    pb.observe(SimpleNamespace(txp_id=np.zeros(3, np.int32),
                               boundaries=np.array([0, 3])))
    with caplog.at_level(logging.WARNING, logger="oarfish_tpu_torch"):
        assert pb.finish(T) is None
    assert "prebuild failed" not in caplog.text


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    names, lengths = golden_transcripts()
    root = tmp_path_factory.mktemp("prebuild")
    bam = root / "x.bam"
    simulate_bam(bam, num_reads=600, seed=42, names=names, lengths=lengths)
    return root, bam


def test_pack_chunk_observer_reassembles_the_store(bams):
    _, bam = bams
    pb = tv4.V4Prebuild()
    seen = []

    def observe(packed):
        seen.append(len(packed.txp_id))
        pb.observe(packed)

    header, store, _, _ = pack_bam_fast(bam, FilterOpts(), bin_width=100,
                                        threads=2, chunk_observer=observe)
    T_ = len(header.ref_names)
    pre = pb.finish(T_)
    assert sum(seen) == store.num_alignments == pre["A"]
    assert pre["R"] == store.num_reads
    txp = np.asarray(store.txp_id, dtype=np.int64)
    np.testing.assert_array_equal(pre["counts"], np.bincount(txp, minlength=T_))
    order = np.argsort(txp, kind="stable")
    rank = np.empty(len(txp), dtype=np.int64)
    rank[order] = np.arange(len(txp)) - np.searchsorted(txp[order],
                                                        txp[order])
    np.testing.assert_array_equal(pre["rank"], rank)
    sizes = np.diff(store.boundaries)
    assert sum(len(v) for v in pre["classes"].values()) == store.num_reads
    for K, ids in pre["classes"].items():
        assert ((sizes[ids] <= K) & (sizes[ids] > K // 2)).all()


def run_v4(bam, out: Path, device="cpu", extra=()):
    argv = ["--alignments", str(bam), "-o", str(out), "--em-impl", "v4",
            "--write-assignment-probs", "--quiet", "--device", device, *extra]
    assert torch_main(argv) == 0
    plan_cache.wait_for_stores()
    return {ext: Path(str(out) + ext).read_bytes() for ext in OUTPUTS}


def test_pointer_file_gives_a_prefetch_hit_with_the_same_bytes(
        bams, tmp_path, monkeypatch, caplog):
    root, bam = bams
    monkeypatch.setenv("OARFISH_PLAN_CACHE", "1")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        first = run_v4(bam, tmp_path / "first")
        assert "prefetching" not in caplog.text
        assert "phase prebuild.finish" in caplog.text
        assert len(list((tmp_path / "plans").glob("*.ptr"))) == 1
        caplog.clear()
        second = run_v4(bam, tmp_path / "second")
    assert "plan cache: prefetching" in caplog.text
    assert "v4 plan prefetch hit" in caplog.text
    assert "v4 routing built" in caplog.text
    assert second == first
    # and a run without any of it, with its own cache, writes them too
    monkeypatch.setenv("OARFISH_PREBUILD", "0")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path / "fresh"))
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        assert run_v4(bam, tmp_path / "plain") == first
    assert "prefetching" not in caplog.text
    assert not list((tmp_path / "fresh").glob("*.ptr"))


def test_stale_pointer_is_ignored(tmp_path, monkeypatch, caplog):
    """A prefetch whose entry belongs to another CSR is not used: the
    build goes on as without it."""
    monkeypatch.setenv("OARFISH_PLAN_CACHE", "1")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    bam = tmp_path / "fake.bam"
    bam.write_bytes(b"not really a bam")
    ptr = plan_cache.bam_pointer_key(bam, "fp")
    assert plan_cache.prefetch_for_bam(bam, "fp") is None  # no pointer yet
    rng = np.random.default_rng(37)
    txp_id, w, boundaries, _, _, _ = random_csr(rng, R=20_000, T=500,
                                                max_k=4)
    d0, o0 = tv4.EmV4Data.build(txp_id, w, boundaries, 500, device="cpu",
                                pointer_key=ptr)
    plan_cache.wait_for_stores()
    assert plan_cache.read_pointer(ptr) == plan_cache.layout_key(
        txp_id, boundaries, 500)
    other = txp_id.copy()
    other[0] = (other[0] + 1) % 500
    pf = plan_cache.prefetch_for_bam(bam, "fp")
    assert pf is not None
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        d1, o1 = tv4.EmV4Data.build(other, w, boundaries, 500, device="cpu",
                                    prefetch=pf)
    assert "pointer was stale" in caplog.text
    assert "prefetch hit" not in caplog.text
    d2, o2 = tv4.EmV4Data.build(other, w, boundaries, 500, device="cpu")
    np.testing.assert_array_equal(o1, o2)
    assert torch.equal(d1.w_txp, d2.w_txp)


class FakePrefetch:
    key = "fake"

    def __init__(self, status):
        self._status = status

    def status(self):
        return self._status

    def finish(self, structural_key, weights, dtype, device):
        return None  # never used: the build goes on as without it


@pytest.mark.parametrize("status", ["ok", "failed"])
def test_hedge_aborts_on_ok_and_survives_failed(bams, tmp_path, monkeypatch,
                                                 status):
    _, bam = bams
    spies = []

    class SpyPrebuild(tv4.V4Prebuild):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.aborted_quiet = False
            self.observed = 0
            self.pre = None
            spies.append(self)

        def observe(self, packed):
            self.observed += 1
            super().observe(packed)

        def abort(self, quiet=False):
            self.aborted_quiet |= quiet
            super().abort(quiet=quiet)

        def finish(self, num_txps):
            self.pre = super().finish(num_txps)
            return self.pre

    monkeypatch.setattr(tbulk, "V4Prebuild", SpyPrebuild)
    monkeypatch.setattr(plan_cache, "prefetch_for_bam", lambda *_: None)
    base = run_v4(bam, tmp_path / "none")
    assert spies[-1].observed > 0 and not spies[-1].aborted_quiet
    assert spies[-1].pre is not None
    monkeypatch.setattr(plan_cache, "prefetch_for_bam",
                        lambda *_: FakePrefetch(status))
    got = run_v4(bam, tmp_path / status)
    spy = spies[-1]
    if status == "ok":
        assert spy.aborted_quiet and spy.observed == 0 and spy.pre is None
    else:
        assert not spy.aborted_quiet and spy.pre is not None
        assert spy.observed == spies[0].observed
    assert got == base


@pytest.mark.cuda
def test_prefetch_hit_on_the_card(bams, tmp_path, monkeypatch, caplog):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, bam = bams
    monkeypatch.setenv("OARFISH_PLAN_CACHE", "1")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    first = run_v4(bam, tmp_path / "first", device="cuda")
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        second = run_v4(bam, tmp_path / "second", device="cuda")
    assert "v4 plan prefetch hit" in caplog.text
    assert second == first
    monkeypatch.setenv("OARFISH_PREBUILD", "0")
    monkeypatch.setenv("OARFISH_PLAN_CACHE_DIR", str(tmp_path / "fresh"))
    assert run_v4(bam, tmp_path / "plain", device="cuda") == first
