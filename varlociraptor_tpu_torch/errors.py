"""Unified error types, mirroring the reference's thiserror enum
(``src/errors.rs:1-93``).

Every user-facing failure raises a ``VarlociraptorError`` subclass with a
message matching the reference's wording where practical, so CLI behavior
and scripted error handling line up.  Modules re-export the classes they
raise (``OverlappingEventsError`` etc. were previously ad-hoc).
"""

from __future__ import annotations


class VarlociraptorError(Exception):
    """Base class of all framework errors (errors.rs Error enum)."""


class InvalidSampleNameError(VarlociraptorError):
    def __init__(self, name):
        super().__init__(f"formula refers to unknown sample {name}")


class InvalidContaminationSampleNameError(VarlociraptorError):
    def __init__(self, name):
        super().__init__(
            f"contamination refers to unknown sample {name}; "
            "it is not defined in the scenario"
        )


class InvalidInheritanceSampleNameError(VarlociraptorError):
    def __init__(self, name):
        super().__init__(
            f"inheritance refers to unknown sample {name}; "
            "it is not defined in the scenario"
        )


class InvalidObservationsSpecError(VarlociraptorError):
    def __init__(self):
        super().__init__("observation files must be provided as samplename=path")


class InvalidLocusError(VarlociraptorError):
    def __init__(self):
        super().__init__("invalid locus for --testcase-locus. Use CHROM:POS syntax")


class NoCandidateFoundError(VarlociraptorError):
    def __init__(self):
        super().__init__("no candidate variant at the given locus")


class MissingPrefixError(VarlociraptorError):
    def __init__(self):
        super().__init__("testcase prefix must be given with --testcase-prefix")


class MissingBCFTagError(VarlociraptorError):
    def __init__(self, name):
        super().__init__(f"expected tag {name} missing from BCF record")


class InvalidBCFRecordError(VarlociraptorError):
    def __init__(self, chrom, pos, msg):
        super().__init__(f"invalid BCF record at {chrom}:{pos}: {msg}")


class NoRecordsFoundError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "unable to estimate TMB because no valid records were found in "
            "the given BCF/VCF"
        )


class UniverseContigNotFoundError(VarlociraptorError):
    def __init__(self, contig):
        super().__init__(
            f"contig {contig} not found in universe definition and no 'all' defined"
        )


class PloidyContigNotFoundError(VarlociraptorError):
    def __init__(self, contig):
        super().__init__(
            f"contig {contig} not found in ploidy definition and no 'all' defined"
        )


class InconsistentObservationsError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "inconsistent observations: input observation BCF files do not "
            "contain exactly the same records"
        )


class InvalidObservationSampleNameError(VarlociraptorError):
    def __init__(self, name):
        super().__init__(
            f"sample {name} (given by --obs) cannot be found in the scenario"
        )


class InvalidObservationFormatError(VarlociraptorError):
    def __init__(self, path=""):
        super().__init__(
            f"invalid observations ({path}): the file has not been "
            "preprocessed with varlociraptor or with a too old version"
        )


class InvalidBNDRecordAltError(VarlociraptorError):
    def __init__(self, spec):
        super().__init__(f"invalid BND record: ALT {spec} does not follow BND spec")


class EmptyObservationsError(VarlociraptorError):
    def __init__(self):
        super().__init__("at least one BCF with observations must be provided")


class OverlappingEventsError(VarlociraptorError, ValueError):
    """the following events are not disjunct (errors.rs OverlappingEvents)."""


class UnsortedVariantFileError(VarlociraptorError, ValueError):
    def __init__(self, previous_locus, current_locus):
        super().__init__(
            f"the input VCF/BCF is not sorted: {previous_locus} > {current_locus}"
        )


class HaplotypeBlockWithBreakendError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "haplotype block consisting of normal variants in combination "
            "with breakends: this is currently unsupported"
        )


class InvalidPriorContaminationEstimateError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "invalid prior contamination estimate. Both --prior-estimate and "
            "--prior-considered-cells have to be specified. The latter has to be >0."
        )


class BreakendMateidWithoutRecidError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "breakend with MATEID found that does not have its own ID set"
        )


class InvalidFDRControlEventsError(VarlociraptorError, ValueError):
    def __init__(self):
        super().__init__(
            "invalid FDR control events, no events provided or none of the "
            "given events matches the events found in the callset"
        )


class UnrealisticIsizeSdError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "unrealistic insert size distribution: the standard deviation is "
            "0.0, consider sampling more reads for estimating alignment properties"
        )


class InvalidVariantPriorError(VarlociraptorError):
    def __init__(self):
        super().__init__(
            "given field for variant heterozygosity or variant somatic "
            "effective mutation rate has to have as many entries as ALT "
            "alleles in the record"
        )


class InvalidPriorConfigurationError(VarlociraptorError, ValueError):
    """prior configuration fails CheckablePrior::check (prior.rs:788-825)."""


class MalformedBamError(VarlociraptorError):
    """BAM/BGZF byte stream violates the spec (truncated block, impossible
    record length, corrupt field). htslib fails these reads with its own
    hts_log errors; our from-scratch reader raises this instead of leaking
    struct/numpy internals."""

    def __init__(self, detail: str):
        super().__init__(f"malformed BAM input: {detail}")


class MalformedBcfError(VarlociraptorError):
    """BCF byte stream violates the spec (truncated/corrupt block or typed
    value). Raised instead of leaking struct/zlib internals."""

    def __init__(self, detail: str):
        super().__init__(f"malformed BCF input: {detail}")


class MalformedVcfError(VarlociraptorError):
    """VCF text record violates the spec (missing columns, non-numeric
    POS)."""

    def __init__(self, detail: str):
        super().__init__(f"malformed VCF input: {detail}")
