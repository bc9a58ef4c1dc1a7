"""The control of the trio call cell's check: the reference put in the
program's place with its per-read likelihood terms in bfloat16, the
precision below the float32 that the configuration's program computes in.
It has to come out as not correct.

    python3 -m portbench.reference.control_trio --seeds 1 2 3 [--loci 1024]

prints, for each seed, ``prob_gap`` and ``af_gap`` of the control against
the reference on ``--loci`` candidates drawn as the cell draws them (the
configuration's full region), beside the limits of ``check_trio``.
"""

from __future__ import annotations

import argparse
import json

from . import check_trio, trio_model
from .check_call import call_gaps, pick_loci


def control(config, traffic, seed, loci=None):
    """{"prob_gap", "af_gap"} of the bfloat16 control against the reference
    on the candidates the cell's check draws for ``seed``."""
    from portbench.lib import calls_input, calls_input_trio

    inputs = calls_input_trio.draw(config, seed)
    pick = pick_loci(len(inputs["pos"]), loci or traffic["check_loci"], seed)
    sub = calls_input.select(inputs, pick)
    ref = trio_model.calls(sub, config)
    low = trio_model.calls(sub, config, lower=True)
    pg, ag = call_gaps(ref, low)
    return {"prob_gap": pg, "af_gap": ag}


def main(argv=None):
    from portbench.lib import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="trio_denovo.call_full_prior")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--loci", type=int, default=None)
    args = ap.parse_args(argv)
    _, _, config, traffic = harness.load_cell(args.workload)
    for seed in args.seeds:
        got = control(config, traffic, seed, args.loci)
        print(json.dumps({"seed": seed, **got,
                          "limits": {k: check_trio.LIMITS[k] for k in got}}), flush=True)


if __name__ == "__main__":
    main()
