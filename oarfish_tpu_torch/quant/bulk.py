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
a batch of bootstrap replicates being one program there). With
`--num-shards > 1` the reads are cut into shards (`parallel/`): `v4`
(`auto` included) runs the sharded v4 EM, its bootstrap replicates as
batches; another formulation without bootstrap replicates runs the sharded
segment-sum EM; another with replicates runs on one device, and a log line
says that `--num-shards` was not used. Under several processes
(`--num-processes`) every process runs the sharded segment-sum EM over its
shard, with one all-reduce per m-step, and process 0 writes; with `{proc}`
inputs each process packed only its own reads
(`_sharded_input_inference_and_write`). A run never changes formulation or
device behind the caller's back: a missing device, a process group that
cannot form, or a kernel that does not build or launch raises, and so does
a `v3`, `v4` or sharded `v4` whose route geometry is not feasible.

With `--em-impl auto|v4` on one device in one process
`quantify_bulk_alignments_from_bam`
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
from ..ops import em as em_ops
from ..ops import em_fast, em_v3, em_v4, plan_cache
from ..ops.em_fast import FastEmData, run_em_fast, run_em_fast_squarem
from ..ops.em_v3 import EmV3Data, run_em_v3, run_em_v3_squarem
from ..ops.em_v4 import (
    EmV4Data,
    V4Prebuild,
    run_em_v4,
    run_em_v4_squarem,
)
from ..parallel.multihost import (
    allgather_hosts,
    global_data_mesh,
    process_count,
    process_index,
    sharded_em_global,
    sharded_em_global_local,
    split_bootstrap_multiplicities,
)
from ..parallel.sharded_em import shard_devices, sharded_em
from ..parallel.sharded_v4 import (
    build_sharded_v4,
    make_sharded_v4_runner,
    sharded_v4_bootstrap,
)
from ..utils import trace
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

# the attribute of a span that counts the hand-written kernels' launches
LAUNCHES = {"launches": trace.launches}
# the attributes of a span that count the all-reduces across processes
ALLREDUCES = {"allreduces": "allreduce.calls",
              "allreduce_s": "allreduce.seconds"}

PORTED_IMPLS = ("segsum", "fast", "pallas", "v3", "v4")

# Below this many alignments the v4 route geometry degenerates (the
# build raises), so auto never tries it.
V4_MIN_ALNS = 1_000_000


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


def _prepare(store: AlignmentStore, coverage: TranscriptCoverage, txps_name,
             opts: FilterOpts, args: Args, device, multi: bool):
    """The host's statistics before the EM: the discard table, the KDE,
    the coverage model (the span `bulk.covmodel`) and the CSR's sizes;
    returns (KDE densities or None, the short-read abundances or None)."""
    log.info("discard table:\n%s", store.discard.to_table())
    if args.sharded_inputs and multi:
        if args.use_kde:
            log.warning(
                "--use-kde with sharded ingest builds the KDE from "
                "this process's reads only"
            )
        if opts.model_coverage:
            # the coverage model is a global per-transcript statistic:
            # sum the bin accumulators across processes before evaluating
            # it (the bin layout depends only on the transcript lengths)
            def _gather_f64(a):
                g = allgather_hosts(np.ascontiguousarray(a).view(np.uint8))
                return g.view(np.float64).sum(axis=0)

            coverage.bins = _gather_f64(coverage.bins)
            coverage.total_weight = _gather_f64(coverage.total_weight)

    dens_prob = None
    if args.use_kde:
        kde = get_kde_model(store, coverage.lenf)
        tlen = coverage.lenf[store.txp_id].astype(np.int64)
        aln_len = (store.end - store.start).astype(np.int64)
        dens_prob = kde.lookup(tlen, aln_len)

    if opts.model_coverage:
        with trace.span("bulk.covmodel"):
            if os.environ.get("OARFISH_COVMODEL") == "torch":
                # the segment-op formulation on the run's device
                cov_flat = logistic_prob_torch(coverage, args.growth_rate,
                                               device=device)
                normalize_read_probs_torch(store, coverage, cov_flat,
                                           args.bin_width, device=device)
            else:
                cov_flat = logistic_prob(coverage, args.growth_rate,
                                         threads=args.threads)
                normalize_read_probs(store, coverage, cov_flat,
                                     args.bin_width, threads=args.threads)

    log.info("Total number of alignment records : %d", store.num_alignments)
    log.info("number of aligned reads : %d", store.num_reads)
    log.info("number of unique alignments : %d", store.num_unique_alignments)

    init = None
    if args.short_quant is not None:
        init = read_short_quant_vec(args.short_quant, txps_name)
    return dens_prob, init


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
    `quantify_bulk_alignments_from_bam`. Its phases are the spans
    `bulk.prepare`, `bulk.route`, `bulk.em`, `bulk.write.quant`,
    `boot.batches` (`ops/bootstrap.py`), `bulk.write.infreps` and
    `bulk.write.probs` (`utils/trace.py`), and on one device `boot.draw`
    on the draw's own thread, from before the route on."""
    device = resolve_device(args.device)
    dtype = resolve_em_dtype(args.em_dtype, device)
    multi = process_count() > 1
    with trace.span("bulk.prepare"):
        dens_prob, init = _prepare(store, coverage, txps_name, opts, args,
                                   device, multi)
    if multi:
        return _multiprocess_inference_and_write(
            store, txps_name, txps_len, opts, args, digest, aln_time_s,
            dens_prob, init, dtype, device,
        )

    impl = args.em_impl
    if impl == "auto":
        impl = choose_auto_impl(
            device.type, store.num_alignments, args.max_em_iter,
            args.num_bootstraps,
        )
        log.info("em-impl auto -> %s", impl)
    if impl not in PORTED_IMPLS:
        raise ValueError(f"unknown --em-impl {impl!r}")
    if args.num_shards > 1:
        if impl == "v4" or args.num_bootstraps == 0:
            return _sharded_inference_and_write(
                store, txps_name, txps_len, opts, args, digest, aln_time_s,
                dens_prob, init, dtype, device, v4=impl == "v4",
            )
        log.info("--num-shards %d not used: --em-impl %s with bootstrap "
                 "replicates runs on one device", args.num_shards, impl)

    # the replicates are drawn on their own thread from here on, while the
    # route, the point EM and the earlier batches run
    draw = None
    if args.num_bootstraps > 0:
        draw = bootstrap_ops.DrawStream(np.random.default_rng(args.seed),
                                        args.num_bootstraps, store.num_reads)
    try:
        return _one_device_inference_and_write(
            store, txps_name, txps_len, opts, args, digest, aln_time_s,
            dens_prob, init, dtype, device, impl, pre, plan_hint, draw,
        )
    finally:
        # a run that raised leaves no thread drawing into the next one
        if draw is not None:
            draw.close()


def _one_device_inference_and_write(
    store, txps_name, txps_len, opts, args, digest, aln_time_s, dens_prob,
    init, dtype, device, impl: str, pre, plan_hint, draw,
) -> np.ndarray:
    """One device in one process: the route of `impl`, the point EM, and
    the replicates of `draw` (a `DrawStream`, None without replicates),
    which is given the route's read order as soon as it is built."""
    T = len(txps_name)
    squarem = args.em_accel == "squarem"
    read_order = None
    with trace.span("bulk.route", impl=impl):
        if impl == "v4":
            if dtype != torch.float32:
                # as in the JAX package, the routed iteration is an f32
                # program
                log.info("--em-impl v4 runs in float32 (--em-dtype %s "
                         "ignored)", args.em_dtype)
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
                    f"--em-impl v4 cannot route these "
                    f"{store.num_alignments} alignments ({e}); use "
                    f"--em-impl pallas"
                ) from e
            log.info("v4 routing built in %.1fs", time.time() - t0)
            log.info("v4 layout: %d big transcripts, %s middle", data.n_big,
                     "fused" if data.seg_id is not None else "unfused")
            run = run_em_v4_squarem if squarem else run_em_v4
            replicates = em_v4.replicate_step
        elif impl == "v3":
            t0 = time.time()
            with trace.span("v3.build") as build:
                try:
                    data, read_order = EmV3Data.build(
                        store.txp_id,
                        combined_weights(store, opts.model_coverage,
                                         dens_prob),
                        store.boundaries, T, dtype=dtype, device=device,
                    )
                except ValueError as e:
                    raise ValueError(
                        f"--em-impl v3 cannot route these "
                        f"{store.num_alignments} alignments ({e}); use "
                        f"--em-impl pallas"
                    ) from e
            log.info("v3 routing built in %.1fs (%s)", time.time() - t0,
                     ", ".join(f"{k} {v:.2f}s" for k, v in build.laps.items()))
            log.info("v3 layout: NPAD %d, %d chunks, Q %d / %d, R1 %d / %d, "
                     "R3 %d / %d", data.npad, data.p1.n_src, data.p1.Q,
                     data.p2.Q, data.p1.R1, data.p2.R1, data.p1.R3,
                     data.p2.R3)
            run = run_em_v3_squarem if squarem else run_em_v3
            replicates = em_v3.replicate_step
        elif impl == "segsum":
            data = build_em_inputs(
                store, T, opts.model_coverage, dens_prob, dtype, device
            )
            run = run_em_squarem if squarem else run_em
            replicates = em_ops.replicate_step
        else:
            data, _read_order = FastEmData.build(
                store.txp_id,
                combined_weights(store, opts.model_coverage, dens_prob),
                store.boundaries, T, dtype=dtype,
                use_pallas_gather=(impl == "pallas"), device=device,
            )
            run = run_em_fast_squarem if squarem else run_em_fast
            replicates = em_fast.replicate_step
        if draw is not None:
            # read multiplicities are exchangeable, so the fast layout's
            # relabeled read order takes the draw as it comes; the v4
            # layout takes it per padded bucket row (both as the JAX
            # package does)
            draw.set_order(read_order)
        init_t = initial_abundances(data, init, dtype)

    t0 = time.time()
    # the span ends after the `.cpu()` that waits for the device
    with trace.span("bulk.em", LAUNCHES, impl=impl) as em:
        counts_t, niter_t = run(
            data, init_t, args.max_em_iter, args.convergence_thresh
        )
        counts = counts_t.double().cpu().numpy()
        niter = int(niter_t)
        em.set(iters=niter, msteps=niter + 1)
    log.info(
        "%s EM on %s (%s) converged after %d iterations in %.3fs",
        impl, device, str(dtype).replace("torch.", ""), niter,
        time.time() - t0,
    )

    with trace.span("bulk.write.quant"):
        unique, total = get_aux_counts(store, T)
        info = get_json_info(args, opts, store.discard, digest, aln_time_s)
        write_output(args.output, info, txps_name, txps_len, counts, unique,
                     total)

    if draw is not None:
        t0 = time.time()
        step = replicates(data, args.max_em_iter, args.convergence_thresh,
                          accel=args.em_accel)
        # v3 has no batch arm: one replicate after another, as in the JAX
        # package
        breps, boot_iters = bootstrap_ops.run_replicates(
            step, draw, init_t,
            batch=1 if impl == "v3" else bootstrap_ops.BOOT_BATCH)
        log.info(
            "%d bootstrap replicates in %.3fs, iterations %s",
            args.num_bootstraps,
            time.time() - t0,
            boot_iters.tolist(),
        )
        with trace.span("bulk.write.infreps"):
            write_infrep_file(args.output, breps)

    with trace.span("bulk.write.probs"):
        write_probs(args, args.output, store, counts, txps_name, opts)

    # a plan stored by this run is on disk before the process ends
    plan_cache.wait_for_stores()
    return counts


def write_probs(args: Args, prefix, store, counts, txps_name,
                opts: FilterOpts) -> None:
    """`--write-assignment-probs`, when asked for, to `prefix`."""
    if args.write_assignment_probs is not None:
        write_out_prob(
            prefix, store, counts, txps_name, args.display_thresh,
            opts.model_coverage,
            compressed=args.write_assignment_probs
            == ReadAssignmentProbOut.COMPRESSED,
        )


def host_init(init: Optional[np.ndarray], T: int, num_reads: int):
    """The EM's start on the host: the caller's abundances, else uniform
    `num_reads / T` (`em.rs:160-167`)."""
    if init is not None:
        return np.asarray(init, dtype=np.float64)
    return np.full(T, num_reads / T)


def _sharded_inference_and_write(
    store, txps_name, txps_len, opts, args, digest, aln_time_s, dens_prob,
    init, dtype, device, v4: bool,
) -> np.ndarray:
    """`--num-shards > 1` in one process: the reads cut into shards, shard
    d on the d % n-th visible card (all on `device` for the CPU). With
    `v4` the sharded routed EM, in `dtype` as the JAX package runs it, and
    its bootstrap replicates as batches; else the sharded segment-sum EM
    (no replicates: the caller keeps those on one device)."""
    T = len(txps_name)
    w = combined_weights(store, opts.model_coverage, dens_prob)
    init_arr = host_init(init, T, store.num_reads)
    devices = shard_devices(device, args.num_shards)
    breps = None
    t0 = time.time()
    if v4:
        with trace.span("bulk.route", impl="v4", shards=args.num_shards):
            try:
                sh, mesh = build_sharded_v4(
                    store.txp_id, w, store.boundaries, T, devices=devices,
                    num_shards=args.num_shards, dtype=dtype,
                )
            except ValueError as e:
                raise ValueError(
                    f"sharded --em-impl v4 cannot route these "
                    f"{store.num_alignments} alignments over "
                    f"{args.num_shards} shards ({e}); use fewer shards or "
                    f"--em-impl segsum"
                ) from e
        log.info("sharded v4 routing built in %.1fs (%d shards, layouts "
                 "%.1fs)", time.time() - t0, sh.num_shards, sh.layout_s)
        log.info("v4 layout: %d big transcripts, %s middle",
                 sh.datas[0].n_big,
                 "fused" if sh.datas[0].seg_id is not None else "unfused")
        run = make_sharded_v4_runner(mesh, args.max_em_iter,
                                     accel=args.em_accel)
        t0 = time.time()
        with trace.span("bulk.em", LAUNCHES, impl="sharded-v4") as em:
            init_t = torch.as_tensor(init_arr,
                                     device=mesh.devices[0]).to(dtype)
            counts_t, niter = run(sh, init_t, args.convergence_thresh)
            counts = counts_t.double().cpu().numpy()
            em.set(iters=int(niter), msteps=int(niter) + 1)
        log.info("sharded-v4 EM on %s (%s) converged after %d iterations "
                 "in %.3fs", device, str(dtype).replace("torch.", ""),
                 int(niter), time.time() - t0)
        if args.num_bootstraps > 0:
            rng = np.random.default_rng(args.seed)
            mult = bootstrap_ops.sample_multiplicities(
                rng, args.num_bootstraps, store.num_reads
            )
            t0 = time.time()
            breps, boot_iters = sharded_v4_bootstrap(
                sh, mesh, init_arr, mult, max_iter=args.max_em_iter,
                convergence_thresh=args.convergence_thresh, dtype=dtype,
                batch=bootstrap_ops.BOOT_BATCH, accel=args.em_accel,
            )
            log.info("%d bootstrap replicates in %.3fs, iterations %s",
                     args.num_bootstraps, time.time() - t0,
                     boot_iters.tolist())
    else:
        with trace.span("bulk.em", impl="sharded-segsum") as em:
            counts, niter = sharded_em(
                store.txp_id, w, store.boundaries, T, init_arr,
                max_iter=args.max_em_iter,
                convergence_thresh=args.convergence_thresh, dtype=dtype,
                devices=devices, num_shards=args.num_shards,
                accel=args.em_accel,
            )
            em.set(iters=niter, msteps=niter + 1)
        log.info("sharded EM on %s (%s) converged after %d iterations in "
                 "%.3fs", device, str(dtype).replace("torch.", ""), niter,
                 time.time() - t0)
    unique, total = get_aux_counts(store, T)
    info = get_json_info(args, opts, store.discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)
    if breps is not None:
        write_infrep_file(args.output, breps)
    write_probs(args, args.output, store, counts, txps_name, opts)
    return counts


def _multiprocess_inference_and_write(
    store, txps_name, txps_len, opts, args, digest, aln_time_s,
    dens_prob, init, dtype, device,
) -> np.ndarray:
    """Several processes: every process runs the sharded segment-sum EM
    over its shard position, with one all-reduce of the partial counts per
    m-step, and process 0 alone writes the outputs. With `{proc}` inputs
    (`args.sharded_inputs`) each process packed only its own reads
    (`_sharded_input_inference_and_write`); otherwise every process packed
    the same BAM and takes the shard of its position. Bootstrap replicates
    run on process 0's device alone, through the segment-sum EM."""
    if args.sharded_inputs:
        return _sharded_input_inference_and_write(
            store, txps_name, txps_len, opts, args, digest, aln_time_s,
            dens_prob, init, dtype, device,
        )

    T = len(txps_name)
    w = combined_weights(store, opts.model_coverage, dens_prob)
    init_arr = host_init(init, T, store.num_reads)
    mesh = global_data_mesh(device)
    with trace.span("bulk.em", ALLREDUCES, impl="multiprocess") as em:
        counts, niter = sharded_em_global(
            store.txp_id, w, store.boundaries, T, init_arr,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            dtype=dtype, mesh=mesh, accel=args.em_accel,
        )
        em.set(iters=niter, msteps=niter + 1)
    log_multiprocess_em(mesh, "", niter, em)
    if process_index() != 0:
        return counts
    unique, total = get_aux_counts(store, T)
    info = get_json_info(args, opts, store.discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)
    if args.num_bootstraps > 0:
        # replicates run on process 0's device alone, in batches of
        # segment sums that cost about as many single runs: 8 replicates of
        # a 2,000,000-read CSR took 22 s as one batch on one H100, 8 single
        # runs 18 s, the main EM of 2 processes 4-5 s
        t0 = time.time()
        with trace.span("bulk.route", impl="segsum") as inputs:
            data = build_em_inputs(store, T, opts.model_coverage, dens_prob,
                                   dtype, device)
        breps = bootstrap_ops.bootstrap(
            data, args.num_bootstraps,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            init_abundances=init,
            seed=args.seed,
            accel=args.em_accel,
        )
        log.info("%d bootstrap replicates on process 0 in %.3fs (inputs "
                 "%.3fs)", args.num_bootstraps, time.time() - t0,
                 inputs.seconds)
        write_infrep_file(args.output, np.asarray(breps))
    write_probs(args, args.output, store, counts, txps_name, opts)
    return counts


def log_multiprocess_em(mesh, ingest: str, niter: int,
                        em: trace.Span) -> None:
    log.info(
        "multi-process EM (%d processes, %d shards%s) converged after %d "
        "iterations in %.3fs; %d all-reduces, %.3fs in them",
        mesh.num_processes, mesh.num_shards, ingest, niter, em.seconds,
        em.attrs["allreduces"], em.attrs["allreduce_s"],
    )


def _sharded_input_inference_and_write(
    store, txps_name, txps_len, opts, args, digest, aln_time_s,
    dens_prob, init, dtype, device,
) -> np.ndarray:
    """Distributed ingest: this process's `store` holds only its own reads
    (disjoint across processes). The EM runs over all processes with shard
    shapes agreed across them; the global read count seeds the uniform
    init; the per-transcript aux counts and the discard counters are
    gathered and summed before process 0 writes. Bootstrap replicates are
    jointly one global multinomial through the splitting property
    (`split_bootstrap_multiplicities`). `--write-assignment-probs` writes
    one part file per process (`P.part{i}.prob[.lz4]`), since read names
    live only on their owner."""
    import dataclasses

    from ..host.filters import DiscardTable

    T = len(txps_name)
    w = combined_weights(store, opts.model_coverage, dens_prob)
    r_global = int(
        allgather_hosts(np.array([store.num_reads], dtype=np.int64)).sum()
    )
    init_arr = host_init(init, T, r_global)
    mesh = global_data_mesh(device)
    with trace.span("bulk.em", ALLREDUCES, impl="multiprocess") as em:
        counts, niter = sharded_em_global_local(
            store.txp_id, w, store.boundaries, T, init_arr,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            dtype=dtype, mesh=mesh, accel=args.em_accel,
        )
        em.set(iters=niter, msteps=niter + 1)
    log_multiprocess_em(
        mesh, f", sharded ingest: {store.num_reads}/{r_global} local reads",
        niter, em)

    # reduce the write-side statistics across processes (tiny)
    unique_l, total_l = get_aux_counts(store, T)
    unique = allgather_hosts(unique_l).sum(axis=0)
    total = allgather_hosts(total_l).sum(axis=0)
    dfields = [f.name for f in dataclasses.fields(DiscardTable)]
    dvals = allgather_hosts(
        np.array([getattr(store.discard, f) for f in dfields],
                 dtype=np.int64)
    ).sum(axis=0)
    discard = DiscardTable(**{f: int(v) for f, v in zip(dfields, dvals)})

    breps = None
    if args.num_bootstraps > 0:
        t0 = time.time()
        mult_local = split_bootstrap_multiplicities(
            args.num_bootstraps, store.num_reads, args.seed
        )
        breps, boot_iters = sharded_em_global_local(
            store.txp_id, w, store.boundaries, T, init_arr,
            max_iter=args.max_em_iter,
            convergence_thresh=args.convergence_thresh,
            dtype=dtype, mesh=mesh, accel=args.em_accel,
            mult_local=mult_local,
        )
        log.info(
            "%d bootstrap replicates (sharded ingest) in %.3fs, "
            "iterations %s", args.num_bootstraps, time.time() - t0,
            boot_iters,
        )

    if args.write_assignment_probs is not None:
        # every process owns its reads' names and probabilities
        part = type(args.output)(f"{args.output}.part{process_index()}")
        write_probs(args, part, store, counts, txps_name, opts)
        log.info("assignment probabilities written per process: %s.prob",
                 part)

    if process_index() != 0:
        return counts
    info = get_json_info(args, opts, discard, digest, aln_time_s)
    write_output(args.output, info, txps_name, txps_len, counts, unique, total)
    if breps is not None:
        write_infrep_file(args.output, np.asarray(breps))
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
    """Alignment-mode entry (`bulk.rs:212-259`): one job, the span
    `bulk.job` (`utils/trace.py`), its first phase `bulk.ingest`."""
    with trace.job("bulk.job"):
        # fail before the pack, not after it
        resolve_device(args.device)
        with trace.span("bulk.ingest"):
            ingest = _ingest(args, opts)
        return perform_inference_and_write_output(*ingest)


def _ingest(args: Args, opts: FilterOpts):
    """The BAM into the CSR (the span `bulk.pack`) and the v4 layout's
    prebuild finished (`prebuild.finish`); returns the arguments of
    `perform_inference_and_write_output`."""
    from ..host.packer import pack_bam_fast

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
        and process_count() == 1
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
    try:
        # the packer gives the span its timings as attributes
        with trace.span("bulk.pack"):
            header, store, coverage, _num_unmapped = pack_bam_fast(
                args.alignments,
                opts,
                bin_width=args.bin_width,
                # all threads go to the decoder: its pipeline mode
                # overlaps the consumer phases itself
                threads=max(args.threads, 1),
                sort_check_num=args.sort_check_num,
                keep_names=opts.write_assignment_probs,
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
    pre = None
    if prebuilder is not None:
        with trace.span("prebuild.finish"):
            pre = prebuilder.finish(len(txps_name))
    aln_time_s = time.time() - t0
    log.info("Parsing of alignments from input took %.3fs", aln_time_s)
    return (store, coverage, txps_name, txps_len, opts, args, digest,
            aln_time_s, pre, (prefetch, pointer_key))
