"""Sharding of the calling workload over devices and processes (torch).

Counterpart of ``varlociraptor_tpu/parallel``.  The workload's parallel axis
is candidate loci: every locus is an independent Bayesian evaluation, so the
engine's locus batch is split data-parallel over the shards of a
:class:`~.sharding.LocusMesh` (a list of devices, and in a multi-process run
the ``torch.distributed`` process group), each shard running the port's
engine, and so K1, on its own device.  The forward pass needs no collective;
the one cross-shard merge, the genome-wide probability distribution of
global FDR, rides :func:`~.sharding.all_gather_rows`.

The reference has no distributed backend: its users shard a genome by
region across jobs.  Here that is a first-class path: region shards in
separate processes, merged by the collective and filtered by
``filtration.fdr.control_fdr_sharded``.
"""
