"""The state carried across from the JAX package: the posterior engine's
setup tables, the pair-HMM's gap model and the alignment properties.

The posterior engine's "weights" are its setup tables: per-sample active
subgrids, spectra and integration masks, support classes, the unique
(nu, kappa) classes of each contaminated plane, the l2fc masks of each
constrained branch, the contamination graph and the AFD backbone.
:func:`engine_state` flattens them into a dict of numpy arrays; it reads
only attributes that the JAX ``PosteriorEngine`` and the port's share, so
the same function serves both:

    state = engine_state_from_jax(jax_engine)          # no torch needed
    engine = PosteriorEngine.from_state(state, "cuda")  # no jax needed

The port's own ``PosteriorEngine.__init__`` produces the same state bit for
bit (tests/test_torch_posterior.py), which is how a machine without JAX runs
with the reference's tables.
"""

from __future__ import annotations

import numpy as np


def engine_state(engine) -> dict:
    """Setup tables of a posterior engine (JAX or port) as numpy arrays."""
    S = engine.n_samples
    st = {
        "grid_values": np.asarray(engine.grid.values),
        "resolution": np.float64(engine.resolution),
        "all_uniform_prior": np.bool_(engine.all_uniform_prior),
        "n_artifact_combos": np.int64(
            -1 if engine.n_artifact_combos is None else engine.n_artifact_combos
        ),
        "n_samples": np.int64(S),
        "zero_idx": np.int64(engine.zero_idx),
        "zero_s": np.asarray(engine.zero_s, dtype=np.int64),
        "is_range": engine.is_range,
        "rng_start": engine.rng_start,
        "rng_end": engine.rng_end,
        "rng_lexcl": engine.rng_lexcl,
        "rng_rexcl": engine.rng_rexcl,
        "set_mask": engine.set_mask,
        "spectrum_excludes_zero": engine.spectrum_excludes_zero,
        "spectrum_contains_zero": engine.spectrum_contains_zero,
        "branch_has_zero_point": engine.branch_has_zero_point,
        "branch_event": np.asarray(engine.branch_event, dtype=np.int32),
        "event_is_artifact": np.asarray(engine.event_is_artifact, dtype=bool),
        "event_all_absent": np.asarray(engine.event_all_absent, dtype=bool),
        "parent": np.asarray(
            [-1 if p is None else p for p in engine.parent], dtype=np.int64
        ),
    }
    # l2fc masks per branch, in the engine's order: (a, b) with a < b and
    # the [Ga, Gb] bool mask over the two samples' active subgrids
    for bi, lst in engine.branch_lfc_masks.items():
        for k, (a, b, m) in enumerate(lst):
            st[f"branch_lfc_masks/{bi}/{k}/a"] = np.int64(a)
            st[f"branch_lfc_masks/{bi}/{k}/b"] = np.int64(b)
            st[f"branch_lfc_masks/{bi}/{k}/mask"] = np.asarray(m, dtype=bool)
    frac = np.zeros(S, dtype=np.float64)
    for si, _by, f in engine.pairs:
        frac[si] = f
    st["contamination_fraction"] = frac
    comp_of = np.zeros(S, dtype=np.int64)
    for k, comp in enumerate(engine.components):
        comp_of[list(comp)] = k
    st["component_of"] = comp_of
    if engine.valid_vaf_mask is not None:
        st["valid_vaf_mask"] = np.asarray(engine.valid_vaf_mask)
    for si in range(S):
        st[f"values_s/{si}"] = np.asarray(engine.values_s[si])
        st[f"active_idx/{si}"] = np.asarray(engine.active_idx[si])
        st[f"set_mask_s/{si}"] = np.asarray(engine.set_mask_s[si])
        if engine.valid_mask_s[si] is not None:
            st[f"valid_mask_s/{si}"] = np.asarray(engine.valid_mask_s[si])
        cls, masks = engine.support_classes[si]
        st[f"support_classes/{si}/branch_class"] = np.asarray(cls)
        st[f"support_classes/{si}/masks"] = np.asarray(masks)
        st[f"afd_backbone/{si}"] = engine._afd_backbone(si)
    for si, (nu_u, kappa_u, inv) in engine.pair_class.items():
        st[f"pair_class/{si}/nu_u"] = np.asarray(nu_u)
        st[f"pair_class/{si}/kappa_u"] = np.asarray(kappa_u)
        st[f"pair_class/{si}/inv"] = np.asarray(inv)
    return st


def engine_state_from_jax(engine) -> dict:
    """Setup tables of a ``varlociraptor_tpu`` (JAX) engine; feed them to
    ``varlociraptor_tpu_torch.ops.posterior.PosteriorEngine.from_state``."""
    return engine_state(engine)


def pairhmm_from_jax(jax_hmm, device):
    """The port's ``BatchedPairHMM`` with the gap model of a JAX
    ``varlociraptor_tpu.ops.pairhmm.BatchedPairHMM``: its float32 log gap
    array (``gap``), ``mode`` and hop params are taken as they are, so both
    packages pack the same coefficient vectors."""
    from .estimation.alignment_properties import GapParams, HopParams

    from .ops.pairhmm import BatchedPairHMM

    hop = None
    if jax_hmm.hop is not None:
        hop = HopParams(**{k: list(v) for k, v in vars(jax_hmm.hop).items()})
    hmm = BatchedPairHMM(GapParams(), hop_params=hop, mode=jax_hmm.mode, device=device)
    hmm.gap = np.array(jax_hmm.gap, dtype=np.float32)
    return hmm


def alignment_properties_from_jax(props):
    """The port's ``AlignmentProperties`` equal to a JAX one, through the
    JSON form both packages read and write."""
    from .estimation.alignment_properties import AlignmentProperties

    return AlignmentProperties.from_json(props.to_json())
