from .fasta import FastaBuffer  # noqa: F401
from .bam import BamReader  # noqa: F401
from .vcf import VcfReader, VcfWriter, VcfRecord  # noqa: F401
