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

Five EM formulations are ported: `segsum` (`ops/em.py`), `fast` and
`pallas` (`ops/em_fast.py`, the latter with the hand-written sorted-gather
kernel), `v3` (`ops/em_v3.py`, the sorted gather and two GlobalPermutes of
tile permutes; bootstrap replicates one after another) and `v4`
(`ops/em_v4.py`, the routed iteration with its three hand-written kernels,
a batch of bootstrap replicates being one program there). A run never
changes formulation or device behind the caller's back: what is not
ported raises `NotImplementedError`, a missing device or a kernel that
does not build or launch raises, and so does a `v3` or `v4` whose route
geometry is not feasible.

With `--em-impl auto|v4` on one device `quantify_bulk_alignments_from_bam`
hides the v4 layout's A-sized pre-work behind the BAM decode
(`em_v4.V4Prebuild`, fed by the pack's `chunk_observer`;
`OARFISH_PREBUILD=0` turns it off), and where a BAM pointer file of the
plan cache names an entry for this BAM and filter set, reads that entry
during the pack (`plan_cache.Prefetch`). Neither changes a result.
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
from ..ops.em_v3 import EmV3Data, run_em_v3, run_em_v3_squarem
from ..ops.em_v4 import (
    EmV4Data,
    V4Prebuild,
    run_em_v4,
    run_em_v4_squarem,
)
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

PORTED_IMPLS = ("segsum", "fast", "pallas", "v3", "v4")

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
    pre: Optional[dict] = None,
    plan_hint=(None, None),
) -> np.ndarray:
    """Shared inference + output tail (`bulk.rs:83-210`). `pre` carries
    the v4 layout inputs prebuilt during the streaming pack; `plan_hint`
    is (plan-cache Prefetch, BAM pointer key) from
    `quantify_bulk_alignments_from_bam`."""
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
                pre=pre, prefetch=plan_hint[0], pointer_key=plan_hint[1],
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
    elif impl == "v3":
        t0 = time.time()
        build_s: dict = {}
        try:
            data, read_order = EmV3Data.build(
                store.txp_id,
                combined_weights(store, opts.model_coverage, dens_prob),
                store.boundaries, T, dtype=dtype, device=device,
                timings=build_s,
            )
        except ValueError as e:
            raise ValueError(
                f"--em-impl v3 cannot route these {store.num_alignments} "
                f"alignments ({e}); use --em-impl pallas"
            ) from e
        log.info("v3 routing built in %.1fs (%s)", time.time() - t0,
                 ", ".join(f"{k} {v:.2f}s" for k, v in build_s.items()))
        log.info("v3 layout: NPAD %d, %d chunks, Q %d / %d, R1 %d / %d, "
                 "R3 %d / %d", data.npad, data.p1.n_src, data.p1.Q,
                 data.p2.Q, data.p1.R1, data.p2.R1, data.p1.R3, data.p2.R3)
        run = run_em_v3_squarem if squarem else run_em_v3
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
        if impl == "v3":
            # no batch arm: one replicate after another, as in the JAX
            # package
            def one_by_one(i, m):
                counts_b, niter_b = run(
                    data, i[0], args.max_em_iter, args.convergence_thresh,
                    multiplicity=m[0],
                )
                return counts_b.unsqueeze(0), niter_b.unsqueeze(0)

            breps, boot_iters = bootstrap_ops.run_replicates(
                one_by_one, mult, init_t, batch=1)
        else:
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


def filter_fingerprint(opts: FilterOpts) -> str:
    """The filter settings that change which alignments the pack keeps:
    part of a BAM pointer's key (`plan_cache.bam_pointer_key`)."""
    return (
        f"{opts.five_prime_clip};{opts.three_prime_clip};"
        f"{opts.score_threshold};{opts.min_aligned_fraction};"
        f"{opts.min_aligned_len};{opts.which_strand};"
        f"{opts.score_prob_denom}"
    )


def quantify_bulk_alignments_from_bam(args: Args, opts: FilterOpts) -> np.ndarray:
    """Alignment-mode entry (`bulk.rs:212-259`)."""
    from ..host.packer import pack_bam_fast

    # fail before the pack, not after it
    check_ported(args)
    resolve_device(args.device)

    # Hide the v4 layout's A-sized pre-work behind the streaming pack: a
    # V4Prebuild thread takes the filtered CSR chunks as they land. Where
    # this BAM with these filters ran before, the plan cache's entry is
    # read during the pack too (checked against the packed CSR's own key
    # before use). The prebuilder is a hedge: it keeps running until the
    # prefetched entry is known to be readable, then stops.
    prebuilder = prefetch = pointer_key = None
    observer = None
    if (
        args.em_impl in ("auto", "v4")
        and args.num_shards <= 1
        and os.environ.get("OARFISH_PREBUILD") != "0"
    ):
        fp = filter_fingerprint(opts)
        prefetch = plan_cache.prefetch_for_bam(args.alignments, fp)
        pointer_key = plan_cache.bam_pointer_key(args.alignments, fp)
        prebuilder = V4Prebuild()
        pf_box = [prefetch]
        hedge_done = [False]

        def observer(packed):
            # the pointer may also land mid-pack (an earlier run's store
            # finishing): look again at every chunk (a stat and a tiny
            # read) so that a late plan still overlaps most of the pack
            if pf_box[0] is None:
                pf_box[0] = plan_cache.prefetch_for_bam(args.alignments, fp)
            pf = pf_box[0]
            if pf is not None and not hedge_done[0] and pf.status() == "ok":
                hedge_done[0] = True
                prebuilder.abort(quiet=True)
            if not hedge_done[0]:
                prebuilder.observe(packed)

    t0 = time.time()
    pack_timings: dict = {}
    try:
        header, store, coverage, _num_unmapped = pack_bam_fast(
            args.alignments,
            opts,
            bin_width=args.bin_width,
            # all threads go to the decoder: its pipeline mode overlaps
            # the consumer phases itself
            threads=max(args.threads, 1),
            sort_check_num=args.sort_check_num,
            keep_names=opts.write_assignment_probs,
            timings=pack_timings,
            chunk_observer=observer,
        )
    except BaseException:
        if prebuilder is not None:
            prebuilder.abort()
        raise
    if prebuilder is not None:
        prefetch = pf_box[0]
    verify_header(header, args.alignments)
    txps_name = header.ref_names
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)
    log.info("parsed reference information for %d transcripts.", len(txps_name))
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}
    t_pb = time.time()
    pre = prebuilder.finish(len(txps_name)) if prebuilder else None
    if os.environ.get("OARFISH_PHASE_TIMING"):
        log.info("phase prebuild.finish %.3fs", time.time() - t_pb)
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
        pre=pre,
        plan_hint=(prefetch, pointer_key),
    )
