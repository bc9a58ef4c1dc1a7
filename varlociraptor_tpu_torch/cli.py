"""Command-line interface of the torch port.

    python -m varlociraptor_tpu_torch estimate alignment-properties REF \
        --bam BAM [--num-records N] > PROPS.json
    python -m varlociraptor_tpu_torch preprocess variants REF --bam BAM \
        --candidates VCF --output OBS [--alignment-properties PROPS.json] \
        [--threads N] [--device cuda|cpu]
    python -m varlociraptor_tpu_torch call variants generic --scenario YAML \
        --obs S=OBS ... --output VCF [--device cuda|cpu]
    python -m varlociraptor_tpu_torch call variants tumor-normal --tumor OBS \
        --normal OBS [--purity P] --output VCF [--device cuda|cpu]
    python -m varlociraptor_tpu_torch call cnvs CALLS --purity P \
        --output VCF [--tumor-obs OBS --normal-obs OBS] [--device cuda|cpu]
    python -m varlociraptor_tpu_torch filter-calls control-fdr CALLS \
        --events E ... --fdr A --output VCF
    python -m varlociraptor_tpu_torch estimate contamination --sample OBS \
        --contaminant OBS [--output TSV] [--device cuda|cpu]

The flags follow ``varlociraptor_tpu/cli.py`` for these commands.  The
device of the pair-HMM (preprocess), of the posterior engine (call variants,
estimate contamination) and of the CNV Viterbi (call cnvs) defaults to
``cuda``; asking for it without a card is an error, never a silent fall back
to the CPU.  Observation files are the port's own (``.obs``, ``.jsonl``) or
the reference's v15 BCF/VCF, which are read record by record.  ``preprocess --pairhmm-mode homopolymer``
runs the positional-gap kernel K4; ``preprocess --threads N`` runs N worker
processes, each with its pair-HMM on the same device.
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
                    help="host worker processes, each running its pair-HMM on "
                         "--device (the candidates are cut into N shards at "
                         "locus- and haplotype-safe points)")
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

    # experimental CNV segmentation (the reference ships this disabled,
    # cli.rs:641-680; same caveat applies)
    cn = call_sub.add_parser(
        "cnvs", help="EXPERIMENTAL: HMM CNV segmentation of tumor/normal calls"
    )
    cn.add_argument("calls", help="tumor-normal calls VCF/BCF")
    cn.add_argument("--output", required=True)
    cn.add_argument("--tumor-sample", default="tumor")
    cn.add_argument("--normal-sample", default="normal")
    cn.add_argument("--purity", type=float, required=True)
    cn.add_argument("--min-bayes-factor", type=float, default=1.01)
    cn.add_argument("--max-dist", type=int, default=10**9)
    cn.add_argument("--tumor-obs", default=None,
                    help="tumor observation file: per-locus depth comes from "
                         "its depth observations (raw pre-subsampling "
                         "coverage) instead of the calls' FORMAT DP")
    cn.add_argument("--normal-obs", default=None)

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

    ct = est_sub.add_parser("contamination")
    ct.add_argument("--sample", required=True)
    ct.add_argument("--contaminant", required=True)
    ct.add_argument("--output", default=None)
    ct.add_argument("--output-plot", default=None)
    ct.add_argument("--output-max-vaf-variants", default=None)
    ct.add_argument("--prior-estimate", type=float, default=None)
    ct.add_argument("--prior-considered-cells", type=int, default=None)
    ct.add_argument("--resolution", type=int, default=100)

    for sp in (pv, cg, tn, cn, ct):
        sp.add_argument(
            "--device", default="cuda",
            help="device of the pair-HMM (preprocess), of the posterior "
                 "engine (call variants, estimate contamination) or of the "
                 "CNV Viterbi (call cnvs): cuda (default) or cpu",
        )
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

    if args.command == "estimate" and args.what == "contamination":
        return _estimate_contamination(args)

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

    if args.command == "call" and args.kind == "cnvs":
        from .calling.cnvs import call_cnvs

        n = call_cnvs(
            args.calls,
            args.output,
            tumor_sample=args.tumor_sample,
            normal_sample=args.normal_sample,
            purity=args.purity,
            min_bayes_factor=args.min_bayes_factor,
            max_dist=args.max_dist,
            tumor_obs=args.tumor_obs,
            normal_obs=args.normal_obs,
            device=args.device,
        )
        print(f"called {n} CNV segments (EXPERIMENTAL)", file=sys.stderr)
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


def _estimate_contamination(args):
    from .estimation.contamination import (
        estimate_contamination,
        write_plot,
        write_tsv,
    )

    prior = None
    if (args.prior_estimate is None) != (args.prior_considered_cells is None):
        print(
            "--prior-estimate requires --prior-considered-cells "
            "(and vice versa)",
            file=sys.stderr,
        )
        return 1
    if args.prior_estimate is not None:
        prior = (args.prior_estimate, args.prior_considered_cells)
    result = estimate_contamination(
        args.sample,
        args.contaminant,
        prior_estimate=prior,
        resolution=args.resolution,
        device=args.device,
    )
    if args.output:
        with open(args.output, "w") as out:
            write_tsv(result, out)
    else:
        write_tsv(result, sys.stdout)
    if args.output_plot:
        write_plot(result, args.output_plot)
    if args.output_max_vaf_variants:
        with open(args.output_max_vaf_variants, "w") as f:
            print("chrom\tpos", file=f)
            for chrom, pos in result["max_vaf_variants"]:
                print(f"{chrom}\t{pos}", file=f)
    print(
        f"max posterior contamination: "
        f"{result['max_posterior_contamination']:.4f} "
        f"({result['n_variants']} informative variants)",
        file=sys.stderr,
    )
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
