"""Command-line interface.

Counterpart of the JAX package's `cli.py`: the reference's flag surface
(`src/prog_opts.rs:250-566`) and mode dispatch (`src/main.rs:319-485`)
with the same flag names, defaults, filter-group overlay semantics and
input-mode exclusivity rules, plus `--device`; `--profile-dir` traces
the run with `torch.profiler` where the JAX CLI uses `jax.profiler`.
Every input mode is ported: transcriptome-BAM bulk mode, single-cell
mode (`--single-cell`), raw reads against a transcriptome (`--reads`
with `--annotated` / `--novel` / `--index`), index building alone
(`--only-index`), raw reads against a genome (`--reads --genome
--annotation`) and genome BAMs (`--genome-alignments --annotation`),
each on one device, over
`--num-shards` read shards, or over `--num-processes` processes joined
by a gloo process group (`resolve_processes`, with the JAX package's
environment fallbacks).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

from .config import (
    Args,
    FilterGroup,
    FilterValue,
    ProjProbSource,
    ReadAssignmentProbOut,
    SequencingTech,
    Strand,
    U32_MAX,
    parse_display_thresh,
    resolve_filters,
)


def _pos_f32(s: str) -> float:
    v = float(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"value must be > 0, but got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oarfish-tpu-torch",
        description=(
            "accurate transcript quantification from long-read RNA-seq data "
            "(PyTorch/CUDA engine)"
        ),
    )
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--verbose", action="store_true")

    # alignment mode
    p.add_argument("-a", "--alignments", type=Path)
    # raw read mode
    p.add_argument("--reads", type=lambda s: [Path(x) for x in s.split(",")])
    p.add_argument("--annotated", type=Path)
    p.add_argument("--novel", type=Path)
    p.add_argument("--index", type=Path)
    p.add_argument("--seq-tech", type=SequencingTech.parse)
    p.add_argument("--best-n", type=int, default=100)
    p.add_argument("--dp-cache-cap-mb", type=int)
    # genome mode
    p.add_argument("--genome-alignments", type=Path)
    p.add_argument("--genome", type=Path)
    p.add_argument("--annotation", type=Path)
    p.add_argument("--genome-fasta", type=Path)
    p.add_argument("--no-rescue", action="store_true")
    p.add_argument("--junctions", type=Path)
    p.add_argument("--ignore-annotation-junctions", action="store_true")
    p.add_argument("--projected-prob-beta", type=float, default=10.0)
    p.add_argument(
        "--projected-prob-source",
        type=lambda s: ProjProbSource(s.lower()),
        default=ProjProbSource.SIMILARITY,
    )
    p.add_argument("--junc-miss-discount", type=float, default=1.0)
    # indexing
    p.add_argument("--only-index", action="store_true")
    p.add_argument("--index-out", type=Path)

    p.add_argument("-o", "--output", type=Path)

    # filters (None = not provided; preset defaults applied in resolve)
    p.add_argument(
        "--filter-group",
        type=lambda s: FilterGroup(s.lower()),
        choices=list(FilterGroup),
        metavar="{no-filters,nanocount-filters}",
    )
    p.add_argument("-t", "--three-prime-clip", type=int, default=None)
    p.add_argument("-f", "--five-prime-clip", type=int, default=None)
    p.add_argument("-s", "--score-threshold", type=float, default=None)
    p.add_argument("-m", "--min-aligned-fraction", type=float, default=None)
    p.add_argument("-l", "--min-aligned-len", type=int, default=None)
    p.add_argument("-d", "--strand-filter", type=Strand.parse, default=Strand.BOTH)
    p.add_argument("--score-prob-denom", type=_pos_f32, default=None)

    p.add_argument("--single-cell", action="store_true")

    # coverage model
    p.add_argument("--model-coverage", action="store_true")
    p.add_argument("-k", "--growth-rate", type=float, default=2.0)
    p.add_argument("-b", "--bin-width", type=int, default=100)

    # probability output
    p.add_argument(
        "--write-assignment-probs",
        nargs="?",
        const="uncompressed",
        default=None,
        type=str,
    )
    p.add_argument(
        "--display-thresh", type=parse_display_thresh, default=1e-6
    )

    # EM
    p.add_argument("--max-em-iter", type=int, default=1000)
    p.add_argument("--convergence-thresh", type=float, default=1e-3)
    p.add_argument("-q", "--short-quant", type=str)
    p.add_argument("--num-bootstraps", type=int, default=0)

    p.add_argument("-j", "--threads", type=int, default=3)
    p.add_argument("--sort-check-num", type=int, default=100_000)
    p.add_argument("-u", "--use-kde", action="store_true")

    # engine extensions
    p.add_argument(
        "--device",
        default=None,
        help="torch device of the EM (default: cuda, and an error when no "
        "CUDA device is present; cpu runs on the host on purpose)",
    )
    p.add_argument(
        "--em-dtype",
        choices=["auto", "float32", "float64"],
        default="auto",
        help="EM compute precision (auto: f64 on cpu, f32 on cuda)",
    )
    p.add_argument(
        "--em-impl",
        choices=["auto", "segsum", "fast", "pallas", "v3", "v4"],
        default="auto",
        help="EM formulation (auto: segsum on cpu; on cuda v4 from a "
        "million alignments and 150 expected iterations on, else pallas). "
        "v4 is the routed iteration on static permutation networks, "
        "always f32; v3 is the sorted gather with two static "
        "permutations of the alignment space (never chosen by auto); "
        "pallas is the scatter-free formulation with the "
        "hand-written sorted-gather kernel; fast is the same with torch "
        "indexing; segsum uses segment sums",
    )
    p.add_argument(
        "--em-accel",
        choices=["none", "squarem"],
        default="none",
        help="EM acceleration: squarem runs squared-extrapolation "
        "cycles (same fixed point, typically 3-10x fewer m-steps on "
        "slow-mixing data; the reference's plain EM is the default)",
    )
    p.add_argument("--num-shards", type=int, default=0,
                   help="data-parallel read shards (0 = one per visible card)")
    p.add_argument(
        "--coordinator", default=None,
        help="multi-process: the gloo coordinator's address host:port",
    )
    p.add_argument(
        "--num-processes", type=int, default=None,
        help="multi-process: total process count",
    )
    p.add_argument(
        "--process-id", type=int, default=None,
        help="multi-process: this process's id, 0-based",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a torch.profiler trace of the run here")
    return p


def _filter_value(v, default) -> FilterValue:
    return FilterValue(default, False) if v is None else FilterValue(v, True)


def to_args(ns: argparse.Namespace) -> Args:
    wap = None
    if ns.write_assignment_probs is not None:
        wap = ReadAssignmentProbOut.parse(ns.write_assignment_probs)
    return Args(
        alignments=ns.alignments,
        reads=ns.reads,
        annotated=ns.annotated,
        novel=ns.novel,
        index=ns.index,
        genome_alignments=ns.genome_alignments,
        genome=ns.genome,
        annotation=ns.annotation,
        genome_fasta=ns.genome_fasta,
        no_rescue=ns.no_rescue,
        junctions=ns.junctions,
        ignore_annotation_junctions=ns.ignore_annotation_junctions,
        only_index=ns.only_index,
        index_out=ns.index_out,
        seq_tech=ns.seq_tech,
        best_n=ns.best_n,
        dp_cache_cap_mb=ns.dp_cache_cap_mb,
        output=ns.output,
        quiet=ns.quiet,
        verbose=ns.verbose,
        filter_group=ns.filter_group,
        three_prime_clip=_filter_value(ns.three_prime_clip, U32_MAX),
        five_prime_clip=_filter_value(ns.five_prime_clip, U32_MAX),
        score_threshold=_filter_value(ns.score_threshold, 0.95),
        min_aligned_fraction=_filter_value(ns.min_aligned_fraction, 0.5),
        min_aligned_len=_filter_value(ns.min_aligned_len, 50),
        strand_filter=ns.strand_filter,
        score_prob_denom=ns.score_prob_denom,
        projected_prob_beta=ns.projected_prob_beta,
        projected_prob_source=ns.projected_prob_source,
        junc_miss_discount=ns.junc_miss_discount,
        single_cell=ns.single_cell,
        model_coverage=ns.model_coverage,
        growth_rate=ns.growth_rate,
        bin_width=ns.bin_width,
        write_assignment_probs=wap,
        display_thresh=ns.display_thresh,
        max_em_iter=ns.max_em_iter,
        convergence_thresh=ns.convergence_thresh,
        short_quant=ns.short_quant,
        num_bootstraps=ns.num_bootstraps,
        threads=ns.threads,
        sort_check_num=ns.sort_check_num,
        use_kde=ns.use_kde,
        em_dtype=ns.em_dtype,
        em_impl=ns.em_impl,
        device=ns.device,
        em_accel=ns.em_accel,
        num_shards=ns.num_shards,
        coordinator=ns.coordinator,
        num_processes=ns.num_processes,
        process_id=ns.process_id,
        seed=ns.seed,
    )


def validate_modes(args: Args, parser: argparse.ArgumentParser) -> None:
    """Input-mode exclusivity and requirement rules
    (`prog_opts.rs:252-344,480-490`)."""
    inputs = [
        args.alignments is not None,
        args.reads is not None,
        args.only_index,
        args.genome_alignments is not None,
    ]
    if sum(inputs) != 1:
        parser.error(
            "exactly one of --alignments, --reads, --only-index, "
            "--genome-alignments is required"
        )
    if args.reads is not None:
        has_ref = any(
            x is not None
            for x in (args.annotated, args.novel, args.index, args.genome)
        )
        if not has_ref:
            parser.error(
                "--reads requires a reference: --annotated/--novel/--index "
                "or --genome"
            )
        if args.seq_tech is None:
            parser.error("--reads requires --seq-tech")
    if args.index is not None and (
        args.annotated is not None or args.novel is not None
    ):
        parser.error("--index conflicts with --annotated/--novel")
    if args.genome_alignments is not None and args.annotation is None:
        parser.error("--genome-alignments requires --annotation")
    if args.genome is not None and args.annotation is None:
        parser.error("--genome requires --annotation")
    if args.genome is not None and any(
        x is not None for x in (args.annotated, args.novel, args.index)
    ):
        parser.error("--genome conflicts with --annotated/--novel/--index")
    if args.single_cell:
        if args.alignments is None:
            parser.error("--single-cell requires --alignments")
        if args.write_assignment_probs is not None:
            parser.error("--write-assignment-probs conflicts with --single-cell")
    if args.only_index and args.index_out is None:
        parser.error("--only-index requires --index-out")
    if not args.only_index and args.output is None:
        parser.error("--output is required unless --only-index is given")


def resolve_processes(args: Args) -> None:
    """The process layout, with the JAX package's environment fallbacks
    for absent flags (`OARFISH_COORDINATOR`, `OARFISH_NUM_PROCESSES`,
    `OARFISH_PROCESS_ID`). Above one process this joins the gloo process
    group (`parallel/multihost.initialize_distributed`) before any input is
    opened. A `{proc}` placeholder in `--alignments` or a `--reads` path
    is this process's index (0 in one process); where one was resolved
    under several processes `args.sharded_inputs` is set, and each process
    reads only its own part of the reads."""
    from .parallel.multihost import initialize_distributed, process_index

    coordinator = args.coordinator or os.environ.get("OARFISH_COORDINATOR")
    num_processes = args.num_processes or (
        int(os.environ["OARFISH_NUM_PROCESSES"])
        if os.environ.get("OARFISH_NUM_PROCESSES")
        else None
    )
    process_id = (
        args.process_id
        if args.process_id is not None
        else (
            int(os.environ["OARFISH_PROCESS_ID"])
            if os.environ.get("OARFISH_PROCESS_ID")
            else None
        )
    )
    multi = (num_processes or 0) > 1
    if multi:
        initialize_distributed(coordinator, num_processes, process_id)

    def _resolve_proc(p):
        if p is None or "{proc}" not in str(p):
            return p, False
        pid = process_index() if multi else 0
        return type(p)(str(p).replace("{proc}", str(pid))), True

    args.alignments, sh_a = _resolve_proc(args.alignments)
    sh_r = False
    if args.reads:
        resolved = [_resolve_proc(p) for p in args.reads]
        args.reads = [p for p, _ in resolved]
        sh_r = any(s for _, s in resolved)
    if (sh_a or sh_r) and multi:
        args.sharded_inputs = True


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    args = to_args(ns)
    validate_modes(args, parser)

    level = logging.INFO
    if args.quiet:
        level = logging.WARNING
    if args.verbose:
        level = logging.DEBUG
    logging.basicConfig(
        level=level,
        stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("oarfish_tpu_torch")

    try:
        opts = resolve_filters(args)
    except ValueError as e:
        parser.error(str(e))

    from .parallel.multihost import shutdown_distributed

    resolve_processes(args)
    try:
        if ns.profile_dir is None:
            return run_mode(args, opts, log)
        # trace the whole run, as the JAX CLI's `jax.profiler.trace` does
        with profiled(ns.profile_dir, args):
            return run_mode(args, opts, log)
    finally:
        shutdown_distributed()


def profile_activities(args: Args) -> list:
    """What `--profile-dir` traces: the host always, and the card where the
    run asks for one (`--device` other than cpu, the default included) and
    one is present. It decides nothing about the device: a run that asks
    for a missing card still raises in `resolve_device`."""
    import torch
    from torch.profiler import ProfilerActivity

    from .device import DEFAULT_DEVICE

    activities = [ProfilerActivity.CPU]
    on_card = str(args.device or DEFAULT_DEVICE).split(":")[0] != "cpu"
    if on_card and not args.only_index and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


def profiled(profile_dir: Path, args: Args):
    """`torch.profiler` over the whole run, no schedule: the trace is
    written when the run ends or raises, as a gzipped Chrome trace
    `<host>_<pid>.<ns>.pt.trace.json.gz` in `profile_dir`, so the processes
    of a `--num-processes` run each write their own file. Perfetto,
    `chrome://tracing` or TensorBoard's PyTorch profiler plugin open it.
    Every thread is traced: the bootstrap draw's span (`boot.draw`) runs
    on a thread of its own."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import profile, tensorboard_trace_handler

    return profile(
        activities=profile_activities(args),
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
        on_trace_ready=tensorboard_trace_handler(str(profile_dir),
                                                 use_gzip=True))


def run_mode(args: Args, opts, log) -> int:
    from .quant.bulk import quantify_bulk_alignments_from_bam

    if args.only_index:
        from .quant.raw_reads import only_index

        return only_index(args)
    if args.genome_alignments is not None:
        from .quant.genome import quantify_genome_alignments_from_bam

        quantify_genome_alignments_from_bam(args, opts)
        log.info("oarfish-tpu-torch completed successfully.")
        return 0
    if args.genome is not None:
        from .quant.genome_reads import quantify_genome_raw_reads

        quantify_genome_raw_reads(args, opts)
        log.info("oarfish-tpu-torch completed successfully.")
        return 0
    if args.reads is not None:
        from .quant.raw_reads import quantify_bulk_alignments_raw_reads

        quantify_bulk_alignments_raw_reads(args, opts)
        log.info("oarfish-tpu-torch completed successfully.")
        return 0
    if args.single_cell:
        from .quant.single_cell import quantify_single_cell_from_collated_bam

        quantify_single_cell_from_collated_bam(args, opts)
    else:
        quantify_bulk_alignments_from_bam(args, opts)
    log.info("oarfish-tpu-torch completed successfully.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
