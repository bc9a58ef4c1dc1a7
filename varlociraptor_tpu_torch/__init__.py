"""varlociraptor_tpu_torch: the PyTorch / CUDA port of varlociraptor_tpu.

A second package beside the JAX reference ``varlociraptor_tpu``.  It mirrors
the reference's module paths (``ops/posterior.py`` is the counterpart of
``varlociraptor_tpu/ops/posterior.py``), runs its device code as PyTorch on an
explicit device, and replaces the reference's Pallas TPU kernels with kernels
written by hand for NVIDIA Hopper (``csrc/``).  It imports ``torch`` and never
``jax``.

Covered so far: estimate alignment properties -> preprocess (candidates +
BAM -> observation file, with the K2 / K3 pair-HMM kernels) -> call
(observation files -> calls VCF, the tumor-normal posterior engine with the
K1 class-likelihood kernel) -> FDR filter.  Run it as
``python -m varlociraptor_tpu_torch``.
"""

__version__ = "0.1.0"
