"""Command-line interface of the torch port.

    python -m varlociraptor_tpu_torch estimate alignment-properties REF \
        --bam BAM [--num-records N] > PROPS.json
    python -m varlociraptor_tpu_torch preprocess variants REF --bam BAM \
        --candidates VCF --output OBS [--alignment-properties PROPS.json] \
        [--device cuda|cpu]
    python -m varlociraptor_tpu_torch call variants generic --scenario YAML \
        --obs S=OBS ... --output VCF [--device cuda|cpu]
    python -m varlociraptor_tpu_torch call variants tumor-normal --tumor OBS \
        --normal OBS [--purity P] --output VCF [--device cuda|cpu]
    python -m varlociraptor_tpu_torch filter-calls control-fdr CALLS \
        --events E ... --fdr A --output VCF

The flags follow ``varlociraptor_tpu/cli.py`` for these commands.  The
device of the pair-HMM (preprocess) and of the posterior engine (call)
defaults to ``cuda``; asking for it without a card is an error, never a
silent fall back to the CPU.  ``preprocess --pairhmm-mode homopolymer``
runs the positional-gap kernel K4; ``preprocess --threads > 1`` is not
ported and raises (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="varlociraptor-tpu-torch",
        description="Bayesian variant calling on PyTorch / CUDA "
                    "(port of varlociraptor-tpu)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    # ---- preprocess ----
    pre = sub.add_parser("preprocess", help="preprocess a sample into observations")
    pre_sub = pre.add_subparsers(dest="kind", required=True)
    pv = pre_sub.add_parser("variants")
    pv.add_argument("reference")
    pv.add_argument("--bam", required=True)
    pv.add_argument("--candidates", required=True)
    pv.add_argument("--output", required=True)
    pv.add_argument("--sample-name", default="sample")
    pv.add_argument("--alignment-properties", default=None)
    pv.add_argument("--max-depth", type=int, default=200)
    pv.add_argument(
        "--realignment-window", "--indel-window", type=int, default=64,
        dest="realignment_window",
        help="window around breakpoints for realignment "
             "(reference flag name: --indel-window, cli.rs:310-316)",
    )
    pv.add_argument(
        "--reference-buffer-size", type=int, default=10,
        help="number of contigs kept in the FASTA LRU buffer (cli.rs:268-276)",
    )
    pv.add_argument(
        "--min-bam-refetch-distance", type=int, default=1,
        help="accepted for reference compatibility (cli.rs:278-288); the "
             "block-cached indexed BAM reader makes refetch batching "
             "unnecessary, so the value is not used",
    )
    pv.add_argument("--pairhmm-mode", default="exact", choices=["exact", "fast", "homopolymer"])
    pv.add_argument("--omit-insert-size", action="store_true")
    pv.add_argument("--threads", type=int, default=1,
                    help="host worker processes; only 1 is ported (ROADMAP A12)")
    pv.add_argument("--report-fragment-ids", action="store_true")
    pv.add_argument("--region", default=None,
                    help="restrict to CHROM or CHROM:START-END (region sharding)")
    pv.add_argument("--output-raw-observations", default=None,
                    help="directory for per-locus raw-observation TSVs")
    pv.add_argument("--log-mode", default="default",
                    choices=["default", "each-record"],
                    help="progress logging granularity (cli.rs:348-357)")
    pv.add_argument(
        "--propagate-info-fields",
        nargs="*",
        default=[],
        help="candidate INFO fields copied through to the final calls",
    )

    # ---- call ----
    call = sub.add_parser("call", help="call variants from observations")
    call_sub = call.add_subparsers(dest="kind", required=True)
    cv = call_sub.add_parser("variants")
    cv_sub = cv.add_subparsers(dest="mode", required=True)

    cg = cv_sub.add_parser("generic")
    cg.add_argument("--scenario", required=True)
    cg.add_argument("--obs", nargs="+", required=True, help="sample=observations pairs")
    cg.add_argument("--output", required=True)
    for flag in (
        "omit-strand-bias",
        "omit-read-orientation-bias",
        "omit-read-position-bias",
        "omit-softclip-bias",
        "omit-homopolymer-artifact-detection",
        "omit-alt-locus-bias",
    ):
        cg.add_argument(f"--{flag}", action="store_true")
    cg.add_argument("--full-prior", action="store_true")
    cg.add_argument("--resolution", type=float, default=0.01)

    tn = cv_sub.add_parser("tumor-normal")
    tn.add_argument("--tumor", required=True)
    tn.add_argument("--normal", required=True)
    tn.add_argument("--purity", type=float, default=1.0)
    tn.add_argument("--output", required=True)

    for sp in (pv, cg, tn):
        sp.add_argument(
            "--device", default="cuda",
            help="device of the pair-HMM (preprocess) or of the posterior "
                 "engine (call): cuda (default) or cpu",
        )

    # ---- filter-calls ----
    fc = sub.add_parser("filter-calls", help="filter calls")
    fc_sub = fc.add_subparsers(dest="method", required=True)
    fdr = fc_sub.add_parser("control-fdr")
    fdr.add_argument("calls")
    fdr.add_argument("--output", required=True)
    fdr.add_argument("--events", nargs="+", required=True)
    fdr.add_argument("--fdr", type=float, required=True)
    fdr.add_argument("--var", default=None, help="variant type (SNV/MNV/INS/DEL/...)")
    fdr.add_argument("--min-len", type=int, default=None)
    fdr.add_argument("--max-len", type=int, default=None)
    fdr.add_argument("--mode", default="global-strict",
                     choices=["local-strict", "global-strict", "local-smart", "global-smart"])
    fdr.add_argument("--retain-artifacts", action="store_true")

    # ---- estimate ----
    est = sub.add_parser("estimate", help="estimations")
    est_sub = est.add_subparsers(dest="what", required=True)
    ap = est_sub.add_parser("alignment-properties")
    ap.add_argument("reference")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--omit-insert-size", action="store_true")
    ap.add_argument("--num-records", type=int, default=None)
    return p


def run(argv=None):
    args = build_parser().parse_args(argv)

    if args.command == "preprocess":
        from .estimation.alignment_properties import AlignmentProperties

        from .calling.preprocess import PreprocessOptions, preprocess

        props = None
        if args.alignment_properties:
            with open(args.alignment_properties) as f:
                props = AlignmentProperties.from_json(f.read())
        n = preprocess(
            candidates_path=args.candidates,
            bam_path=args.bam,
            reference_path=args.reference,
            output_path=args.output,
            sample_name=args.sample_name,
            alignment_properties=props,
            options=PreprocessOptions(
                max_depth=args.max_depth,
                indel_window=args.realignment_window,
                pairhmm_mode=args.pairhmm_mode,
                omit_insert_size=args.omit_insert_size,
                propagate_info_fields=tuple(args.propagate_info_fields),
                output_raw_observations=args.output_raw_observations,
                report_fragment_ids=args.report_fragment_ids,
                region=args.region,
                log_mode=args.log_mode,
                n_workers=args.threads,
                reference_buffer_size=args.reference_buffer_size,
            ),
            device=args.device,
        )
        print(f"preprocessed {n} candidate records", file=sys.stderr)
        return 0

    if args.command == "estimate":
        from .estimation.alignment_properties import estimate
        from .io.bam import BamReader
        from .io.fasta import FastaBuffer

        ref = FastaBuffer(args.reference)
        props = estimate(
            BamReader(args.bam, reference=ref),
            omit_insert_size=args.omit_insert_size,
            num_records=args.num_records,
            reference=ref,
        )
        print(props.to_json())
        return 0

    if args.command == "call":
        from .grammar.scenario import Scenario, tumor_normal_scenario

        from .calling.call import CallOptions, call_generic

        if args.mode == "generic":
            scenario = Scenario.from_path(args.scenario)
            obs = dict(kv.split("=", 1) for kv in args.obs)
            options = CallOptions(
                omit_strand_bias=args.omit_strand_bias,
                omit_read_orientation_bias=args.omit_read_orientation_bias,
                omit_read_position_bias=args.omit_read_position_bias,
                omit_softclip_bias=args.omit_softclip_bias,
                omit_homopolymer_artifact_detection=args.omit_homopolymer_artifact_detection,
                omit_alt_locus_bias=args.omit_alt_locus_bias,
                full_prior=args.full_prior,
                resolution=args.resolution,
            )
        else:
            scenario = tumor_normal_scenario(args.purity)
            obs = {"tumor": args.tumor, "normal": args.normal}
            options = CallOptions()
        n = call_generic(scenario, obs, args.output, options, device=args.device)
        print(f"called {n} records", file=sys.stderr)
        return 0

    if args.command == "filter-calls":
        from .filtration.fdr import control_fdr

        n = control_fdr(
            args.calls,
            args.output,
            events=args.events,
            alpha=args.fdr,
            vartype=args.var,
            min_len=args.min_len,
            max_len=args.max_len,
            local=args.mode.startswith("local"),
            smart=args.mode.endswith("smart"),
            smart_retain_artifacts=args.retain_artifacts,
        )
        print(f"kept {n} records", file=sys.stderr)
        return 0

    raise SystemExit(f"unknown command {args.command}")


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
