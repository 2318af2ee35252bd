"""Bulk quantification: BAM → CSR → device EM → output files.

Counterpart of the JAX package's `quant/bulk.py` (`quantify_bulk_alignments_from_bam`,
`bulk.rs:212-259`, and the shared inference/output tail
`perform_inference_and_write_output`, `bulk.rs:83-210`). The host packs and
evaluates the coverage model (on the device instead with
`OARFISH_COVMODEL=torch`, `models/coverage_torch.py`); the EM loop and the
bootstrap batches run on the torch device the caller names (`args.device`,
default `cuda`). There
is no em/em_par split: the device EM is deterministic and uses the serial
path's convergence guard (`niter > 50`), which is the parity target.

Four EM formulations are ported: `segsum` (`ops/em.py`), `fast` and
`pallas` (`ops/em_fast.py`, the latter with the hand-written sorted-gather
kernel), and `v4` (`ops/em_v4.py`, the routed iteration with its three
hand-written kernels, a batch of bootstrap replicates being one program
there). A run never changes formulation or device behind
the caller's back: what is not ported raises `NotImplementedError`, a
missing device or a kernel that does not build or launch raises, and so
does a `v4` whose route geometry is not feasible.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Args, FilterOpts, ReadAssignmentProbOut
from ..device import resolve_device, resolve_em_dtype
from ..host.store import AlignmentStore, TranscriptCoverage
from ..io.bam import verify_header
from ..models.coverage import logistic_prob, normalize_read_probs
from ..models.coverage_torch import (
    logistic_prob_torch,
    normalize_read_probs_torch,
)
from ..models.kde import get_kde_model
from ..ops import bootstrap as bootstrap_ops
from ..ops.em import (
    EmData,
    initial_abundances,
    run_em,
    run_em_squarem,
)
from ..ops import plan_cache
from ..ops.em_fast import FastEmData, run_em_fast, run_em_fast_squarem
from ..ops.em_v4 import EmV4Data, run_em_v4, run_em_v4_squarem
from ..utils.digest import LazyDigest, digest_from_header
from .meta import get_json_info
from .short_read import read_short_quant_vec
from .writers import (
    get_aux_counts,
    write_infrep_file,
    write_out_prob,
    write_output,
)

log = logging.getLogger("oarfish_tpu_torch")

PORTED_IMPLS = ("segsum", "fast", "pallas", "v4")

# Below this many alignments the v4 route geometry degenerates (the
# build raises), so auto never tries it.
V4_MIN_ALNS = 1_000_000


def not_ported(what: str, queue_item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to oarfish_tpu_torch yet "
        f"(ROADMAP.md, {queue_item})"
    )


def choose_auto_impl(
    device_type: str, num_alignments: int, max_em_iter: int,
    num_bootstraps: int,
) -> str:
    """The EM formulation for `--em-impl auto`: `segsum` on the CPU. On
    the card the JAX package's rule: the routed `v4` iteration pays a
    one-shot route build, so it is taken when the run is big enough for a
    viable route geometry and is expected to do at least 150 iterations
    (bootstrap replicates reuse the tables); otherwise `pallas`, the
    scatter-free formulation with the sorted-gather kernel."""
    if device_type == "cpu":
        return "segsum"
    expected_iters = min(max_em_iter, 1000) * (1 + num_bootstraps)
    if num_alignments >= V4_MIN_ALNS and expected_iters >= 150:
        return "v4"
    return "pallas"


def check_ported(args: Args) -> None:
    """Raise for every option whose code path waits for a later port."""
    if args.em_impl == "v3":
        raise not_ported("--em-impl v3", "queue A item 7")
    check_one_device(args)


def check_one_device(args: Args) -> None:
    """Raise for a run across several devices or processes."""
    if args.num_shards > 1 or (args.num_processes or 0) > 1:
        raise not_ported(
            "the sharded / multi-process EM (--num-shards > 1, "
            "--num-processes > 1)", "queue A item 6",
        )


def combined_weights(
    store: AlignmentStore, model_coverage: bool,
    dens_prob: Optional[np.ndarray],
) -> np.ndarray:
    """The constant per-alignment factors folded into one weight vector
    (`em.rs:97-111`: prob * cov_prob * dens_prob)."""
    w = store.as_prob.astype(np.float64)
    if model_coverage:
        w = w * store.cov_prob
    if dens_prob is not None:
        w = w * dens_prob
    return w


def build_em_inputs(
    store: AlignmentStore,
    num_txps: int,
    model_coverage: bool,
    dens_prob: Optional[np.ndarray],
    dtype: torch.dtype,
    device,
) -> EmData:
    """Ship the weighted CSR to the device for the segment-sum EM."""
    return EmData.build(
        store.txp_id,
        combined_weights(store, model_coverage, dens_prob),
        store.read_ids(),
        store.num_reads,
        num_txps,
        dtype=dtype,
        device=device,
    )


def perform_inference_and_write_output(
    store: AlignmentStore,
    coverage: TranscriptCoverage,
    txps_name,
    txps_len,
    opts: FilterOpts,
    args: Args,
    digest: dict,
    aln_time_s: float,
) -> np.ndarray:
    """Shared inference + output tail (`bulk.rs:83-210`)."""
    check_ported(args)
    device = resolve_device(args.device)
    dtype = resolve_em_dtype(args.em_dtype, device)
    log.info("discard table:\n%s", store.discard.to_table())

    dens_prob = None
    if args.use_kde:
        kde = get_kde_model(store, coverage.lenf)
        tlen = coverage.lenf[store.txp_id].astype(np.int64)
        aln_len = (store.end - store.start).astype(np.int64)
        dens_prob = kde.lookup(tlen, aln_len)

    if opts.model_coverage:
        t_cov = time.time()
        if os.environ.get("OARFISH_COVMODEL") == "torch":
            # the segment-op formulation on the run's device
            cov_flat = logistic_prob_torch(coverage, args.growth_rate,
                                           device=device)
            normalize_read_probs_torch(store, coverage, cov_flat,
                                       args.bin_width, device=device)
        else:
            cov_flat = logistic_prob(coverage, args.growth_rate,
                                     threads=args.threads)
            normalize_read_probs(store, coverage, cov_flat, args.bin_width,
                                 threads=args.threads)
        log.info("phase bulk.covmodel %.3f", time.time() - t_cov)

    log.info("Total number of alignment records : %d", store.num_alignments)
    log.info("number of aligned reads : %d", store.num_reads)
    log.info("number of unique alignments : %d", store.num_unique_alignments)

    init = None
    if args.short_quant is not None:
        init = read_short_quant_vec(args.short_quant, txps_name)

    impl = args.em_impl
    if impl == "auto":
        impl = choose_auto_impl(
            device.type, store.num_alignments, args.max_em_iter,
            args.num_bootstraps,
        )
        log.info("em-impl auto -> %s", impl)
    if impl not in PORTED_IMPLS:
        raise ValueError(f"unknown --em-impl {impl!r}")

    T = len(txps_name)
    squarem = args.em_accel == "squarem"
    read_order = None
    if impl == "v4":
        if dtype != torch.float32:
            # as in the JAX package, the routed iteration is an f32 program
            log.info("--em-impl v4 runs in float32 (--em-dtype %s ignored)",
                     args.em_dtype)
            dtype = torch.float32
        t0 = time.time()
        try:
            data, read_order = EmV4Data.build(
                store.txp_id,
                combined_weights(store, opts.model_coverage, dens_prob),
                store.boundaries, T, dtype=dtype, device=device,
            )
        except ValueError as e:
            raise ValueError(
                f"--em-impl v4 cannot route these {store.num_alignments} "
                f"alignments ({e}); use --em-impl pallas"
            ) from e
        log.info("v4 routing built in %.1fs", time.time() - t0)
        log.info("v4 layout: %d big transcripts, %s middle", data.n_big,
                 "fused" if data.seg_id is not None else "unfused")
        run = run_em_v4_squarem if squarem else run_em_v4
    elif impl == "segsum":
        data = build_em_inputs(
            store, T, opts.model_coverage, dens_prob, dtype, device
        )
        run = run_em_squarem if squarem else run_em
    else:
        data, _read_order = FastEmData.build(
            store.txp_id,
            combined_weights(store, opts.model_coverage, dens_prob),
            store.boundaries, T, dtype=dtype,
            use_pallas_gather=(impl == "pallas"), device=device,
        )
        run = run_em_fast_squarem if squarem else run_em_fast
    init_t = initial_abundances(data, init, dtype)

    t0 = time.time()
    counts_t, niter_t = run(
        data, init_t, args.max_em_iter, args.convergence_thresh
    )
    counts = counts_t.double().cpu().numpy()
    niter = int(niter_t)
    log.info(
        "%s EM on %s (%s) converged after %d iterations in %.3fs",
        impl, device, str(dtype).replace("torch.", ""), niter,
        time.time() - t0,
    )

    unique, total = get_aux_counts(store, T)
    info = get_json_info(args, opts, store.discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)

    if args.num_bootstraps > 0:
        t0 = time.time()
        rng = np.random.default_rng(args.seed)
        # read multiplicities are exchangeable, so the fast layout's
        # relabeled read order takes the draw as it comes; the v4 layout
        # takes it per padded bucket row (both as the JAX package does)
        mult = bootstrap_ops.sample_multiplicities(
            rng, args.num_bootstraps, store.num_reads
        )
        if read_order is not None:
            mult = mult[:, read_order]
        breps, boot_iters = bootstrap_ops.run_replicates(
            lambda i, m: run(
                data, i, args.max_em_iter, args.convergence_thresh,
                multiplicity=m,
            ),
            mult, init_t,
        )
        log.info(
            "%d bootstrap replicates in %.3fs, iterations %s",
            args.num_bootstraps,
            time.time() - t0,
            boot_iters.tolist(),
        )
        write_infrep_file(args.output, breps)

    if args.write_assignment_probs is not None:
        write_out_prob(
            args.output,
            store,
            counts,
            txps_name,
            args.display_thresh,
            opts.model_coverage,
            compressed=args.write_assignment_probs
            == ReadAssignmentProbOut.COMPRESSED,
        )

    # a plan stored by this run is on disk before the process ends
    plan_cache.wait_for_stores()
    return counts


def quantify_bulk_alignments_from_bam(args: Args, opts: FilterOpts) -> np.ndarray:
    """Alignment-mode entry (`bulk.rs:212-259`)."""
    from ..host.packer import pack_bam_fast

    # fail before the pack, not after it
    check_ported(args)
    resolve_device(args.device)

    t0 = time.time()
    pack_timings: dict = {}
    header, store, coverage, _num_unmapped = pack_bam_fast(
        args.alignments,
        opts,
        bin_width=args.bin_width,
        # all threads go to the decoder: its pipeline mode overlaps the
        # consumer phases itself
        threads=max(args.threads, 1),
        sort_check_num=args.sort_check_num,
        keep_names=opts.write_assignment_probs,
        timings=pack_timings,
    )
    verify_header(header, args.alignments)
    txps_name = header.ref_names
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)
    log.info("parsed reference information for %d transcripts.", len(txps_name))
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}
    aln_time_s = time.time() - t0
    log.info("Parsing of alignments from input took %.3fs", aln_time_s)

    return perform_inference_and_write_output(
        store,
        coverage,
        txps_name,
        txps_len,
        opts,
        args,
        digest,
        aln_time_s,
    )
