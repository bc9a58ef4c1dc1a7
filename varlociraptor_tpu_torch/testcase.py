"""Golden-testcase runner: replay reference-format testcases in-process.

Re-implements the reference's testcase framework
(``src/testcase/runner/common/mod.rs``): load a
``testcase.yaml`` (schema versions 0-4), write the inline reference to a temp
FASTA, run preprocess with the serialized per-sample options, then call with
the scenario (or the built-in tumor-normal mode), and evaluate the
``expected.posteriors`` / ``expected.allelefreqs`` expressions against the
output record — the same tolerance-based assertion style.
"""

from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path

import yaml

from .calling.call import CallOptions, call_generic
from .calling.preprocess import PreprocessOptions, preprocess
from .estimation.alignment_properties import AlignmentProperties
from .grammar.scenario import Scenario, tumor_normal_scenario
from .io.fasta import FastaBuffer
from .io.vcf import VcfReader
from .utils.logprob import np_log_from_phred


class TestcaseError(Exception):
    pass


class Testcase:
    def __init__(self, path):
        self.dir = Path(path)
        with open(self.dir / "testcase.yaml") as f:
            self.doc = yaml.safe_load(f)
        self.version = str(self.doc.get("version", "0"))

    # ------------------------------------------------------------------
    @property
    def sample_names(self):
        return list(self.doc["samples"].keys())

    @property
    def expected(self):
        return self.doc.get("expected") or {}

    @property
    def record_index(self):
        return int(self.doc.get("record-index", 0))

    def omit(self, name):
        return bool(self.doc.get(f"omit_{name}", False))

    def _options(self, sample=None):
        """Parse the serialized rust CLI options json (best effort)."""
        raw = None
        if sample is not None:
            raw = self.doc["samples"][sample].get("options")
        if raw is None:
            raw = self.doc.get("options")
        if raw is None:
            return {}
        try:
            d = json.loads(raw)
        except json.JSONDecodeError:
            return {}
        # drill into {"Call"/{"Preprocess": {"kind": {"Variants": {...}}}}
        for key in ("Call", "Preprocess"):
            if key in d:
                d = d[key]
                break
        if "kind" in d:
            d = d["kind"]
        if "Variants" in d:
            d = d["Variants"]
        return d

    def mode(self):
        if "mode" in self.doc:
            return self.doc["mode"]
        opts = self._options()
        mode = opts.get("mode", {})
        if isinstance(mode, dict):
            if "TumorNormal" in mode:
                return "TumorNormal"
            if "Generic" in mode:
                return "Generic"
        return "Generic" if "scenario" in self.doc else "TumorNormal"

    def purity(self) -> float:
        opts = self._options()
        mode = opts.get("mode", {})
        if isinstance(mode, dict) and "TumorNormal" in mode:
            return float(mode["TumorNormal"].get("purity", 1.0))
        return 1.0

    # ------------------------------------------------------------------
    def run(self, workdir=None, pairhmm_mode=None, obs_suffix="jsonl", device="cuda"):
        """Execute the full pipeline; returns (vcf_records, sample_order).
        ``device``: where the pair-HMM (preprocess) and the posterior engine
        (call) run, "cuda" or "cpu".
        ``pairhmm_mode`` overrides the serialized mode (the reference's
        testcase! macro runs most cases in both exact and fast modes).
        ``obs_suffix`` selects the intermediate observation format ("jsonl"
        native; "vcf"/"bcf" the reference's format v15)."""
        workdir = Path(workdir or tempfile.mkdtemp(prefix="vlt-testcase-"))
        workdir.mkdir(parents=True, exist_ok=True)
        # reference FASTA
        ref = self.doc["reference"]
        if "path" in ref:
            ref_path = self.dir / ref["path"]
        else:
            ref_path = workdir / "ref.fa"
            with open(ref_path, "w") as f:
                print(f">{ref['name']}", file=f)
                print(ref["seq"], file=f)
        reference = FastaBuffer(ref_path)

        opts = self._options()

        # preprocess each sample
        obs_paths = {}
        for name, sample in self.doc["samples"].items():
            sopts = self._options(name) or opts
            indel_window = int(
                sopts.get("realignment_window", sopts.get("indel_window", 64)) or 64
            )
            max_depth = int(sopts.get("max_depth", 200) or 200)
            props_raw = sample.get("properties")
            props = (
                AlignmentProperties.from_json(props_raw)
                if props_raw
                else None
            )
            if props is not None and props_raw and "max_read_len" not in props_raw:
                # old testcases lack max_read_len; estimate from BAM
                from .io.bam import BamReader

                bam = BamReader(self.dir / sample["path"])
                props.max_read_len = max((r.read_len for r in bam), default=100)
            out = workdir / f"{name}.obs.{obs_suffix}"
            preprocess(
                candidates_path=self.dir / self.doc["candidate"],
                bam_path=self.dir / sample["path"],
                reference_path=ref_path,
                output_path=out,
                sample_name=name,
                alignment_properties=props,
                options=PreprocessOptions(
                    max_depth=max_depth,
                    indel_window=min(indel_window, 64),
                    # reference CLI flags serialized into the testcase
                    # (cli.rs:918,939: adjust = !omit_mapq_adjustment,
                    #  realign = !atomic_candidate_variants)
                    adjust_prob_mapping=not sopts.get(
                        "omit_mapq_adjustment", False
                    ),
                    realign_indel_reads=not sopts.get(
                        "atomic_candidate_variants", False
                    ),
                    pairhmm_mode=pairhmm_mode
                    or sopts.get("pairhmm_mode", "exact")
                    or "exact",
                    omit_insert_size=bool(sopts.get("omit_insert_size", False)),
                ),
                reference=reference,
                device=device,
            )
            obs_paths[name] = out

        # scenario
        if self.mode() == "TumorNormal" and "scenario" not in self.doc:
            scenario = tumor_normal_scenario(self.purity())
        else:
            scenario = Scenario.from_path(self.dir / self.doc["scenario"])

        # samples without observations get empty pileups (the reference allows
        # Option<bcf::Reader> = None per sample, calling.rs:55-81)

        out_vcf = workdir / "calls.vcf"
        call_options = CallOptions(
            omit_strand_bias=self.omit("strand_bias"),
            omit_read_orientation_bias=self.omit("read_orientation_bias"),
            omit_read_position_bias=self.omit("read_position_bias"),
            omit_softclip_bias=self.omit("softclip_bias"),
            omit_homopolymer_artifact_detection=self.omit(
                "homopolymer_artifact_detection"
            ),
            omit_alt_locus_bias=self.omit("alt_locus_bias"),
        )
        call_generic(scenario, obs_paths, out_vcf, call_options, device=device)
        reader = VcfReader(out_vcf)
        records = reader.records()
        return records, reader.sample_names

    # ------------------------------------------------------------------
    def check(self, workdir=None, pairhmm_mode=None, device="cuda"):
        """Run + evaluate expectations. Raises AssertionError on failure."""
        records, sample_order = self.run(workdir, pairhmm_mode=pairhmm_mode, device=device)
        if not records:
            raise TestcaseError("no output records")
        is_bnd = records[0].info_get("SVTYPE") == "BND"
        targets = records if is_bnd else records[self.record_index : self.record_index + 1]
        if not targets:
            raise TestcaseError(f"record index {self.record_index} out of range")

        for rec in targets:
            env = {}
            for key, val in rec.info.items():
                if key.startswith("PROB_") and val is not True:
                    try:
                        phred = float(str(val).split(",")[0])
                    except ValueError:
                        continue
                    env[key] = phred
                    env[f"PLAIN_{key}"] = float(
                        2.718281828459045 ** np_log_from_phred(phred)
                    )
            for name, sample in zip(sample_order, rec.samples):
                try:
                    env[name] = float(sample.get("AF", "nan"))
                except ValueError:
                    pass

            for expr in self.expected.get("posteriors", []) or []:
                assert _eval_expr(expr, env), f"posterior expectation failed: {expr!r} with {_relevant(env, expr)}"
            for expr in self.expected.get("allelefreqs", []) or []:
                assert _eval_expr(expr, env), f"allelefreq expectation failed: {expr!r} with {_relevant(env, expr)}"
        return True


def _relevant(env, expr):
    return {k: v for k, v in env.items() if k in expr}


def _eval_expr(expr: str, env: dict) -> bool:
    """Evaluate a reference `eval`-crate expression with python."""
    py = expr.replace("&&", " and ").replace("||", " or ").replace("!=", "__NE__")
    py = re.sub(r"(?<![<>=!])=(?!=)", "==", py)  # lone = means equality in eval crate? keep ==
    py = py.replace("__NE__", "!=")
    names = set(re.findall(r"[A-Za-z_][A-Za-z0-9_.\-]*", expr))
    local = {}
    for n in names:
        if n in env:
            local[n] = env[n]
    local.setdefault("inf", float("inf"))
    local.setdefault("nan", float("nan"))
    try:
        return bool(eval(py, {"__builtins__": {}}, local))  # noqa: S307
    except Exception as e:  # noqa: BLE001
        raise AssertionError(f"cannot evaluate {expr!r}: {e} (env {local})")
