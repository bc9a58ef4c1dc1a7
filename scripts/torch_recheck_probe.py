"""Card-vs-CPU observation recheck of the port's preprocess, with the reads
of every record that differs.

Builds (or reuses) a synthetic BAM world (``bench_utils.synth_preprocess_world``),
estimates its alignment properties, preprocesses each sample on the card
``--card-runs`` times (the whole candidate file, as ``chip_smoke.py``'s
phases (d) and (e) do) and its first ``--n-cpu`` candidates on the CPU (64
loci per pair-HMM call, as their recheck does), then prints one JSON line
per sample: whether the card's runs equal each other bit for bit, the
recheck's verdict (``compare.compare_observation_files``), the pair-HMM
launches by kernel, and for each record whose read counts differ its reads'
prob_alt / prob_ref in both files.  With ``--items`` the head also runs on
the card, and the column route's results are held item by item: the
largest difference, the items that differ, and the pairs of one read's
alleles that tie on one device and not on the other.

    python scripts/torch_recheck_probe.py --work build/probe --genome-len 1500000 \
        --homopolymer            # phase (e)'s world and pair-HMM mode
    python scripts/torch_recheck_probe.py --work build/probe2 --world build/probe

``--world`` reuses another run's world and properties (the draws depend on
the arguments alone), so that two checkouts can be held to the same inputs:
copy the script into the other checkout and run it there (the world's
files are named as ``--work`` was given, so give it as an absolute path).
"""

import argparse
import json
import pickle
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def launch_counts():
    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    out = {"exact": phc.exact_forward.launches, "general": phc.general_forward.launches,
           "positional": phc.positional_forward.launches}
    try:
        from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf
    except ImportError:  # a checkout without the wavefront routes
        return out
    out.update({f"wavefront_{f}": fn.launches for f, fn in pwf.WRAPPERS.items()})
    return out


def world_and_props(args, work):
    """The world's dict, the properties' path and whether the world is the
    homopolymer one: built here, or reused from ``--world``."""
    import contextlib
    import io

    from varlociraptor_tpu_torch import cli
    from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world

    src = Path(args.world) if args.world else work
    if not args.world:
        g = args.genome_len
        w = synth_preprocess_world(work / "world", seed=0, genome_len=g,
                                   n_germline=g // 2000, n_somatic=g // 4000,
                                   n_decoy=g // 4000, homopolymer=args.homopolymer)
        with open(work / "world.pkl", "wb") as f:
            pickle.dump({"world": w, "homopolymer": args.homopolymer}, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.run(["estimate", "alignment-properties", w["fasta"], "--bam", w["normal"]])
        if rc != 0:
            raise SystemExit(f"estimate returned {rc}")
        (work / "props.json").write_text(buf.getvalue())
    with open(src / "world.pkl", "rb") as f:
        saved = pickle.load(f)
    return saved["world"], src / "props.json", saved["homopolymer"]


def recording_items(log):
    """Wrap the column route's ``forward_items`` so that every call's items,
    flavour and results are appended to ``log``; returns the undo."""
    from varlociraptor_tpu_torch.ops import pairhmm as pph

    fn = pph.forward_items

    def spy(alleles, reads, quals, gap, device, general, hop=None):
        out = fn(alleles, reads, quals, gap, device, general, hop=hop)
        log.append({"items": ([bytes(a) for a in alleles], [bytes(r) for r in reads],
                              [bytes(bytearray(q)) for q in quals]),
                    "gap": gap, "general": general, "hop": hop, "out": out})
        return out

    pph.forward_items = spy
    return lambda: setattr(pph, "forward_items", fn)


def compare_items(card, cpu, floor=-100.0, tol=1e-4):
    """The column route's results item by item, card against CPU (the same
    calls in the same order); the worst items re-run alone on the card."""
    import numpy as np

    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    if len(card) != len(cpu):
        return {"calls_differ": [len(card), len(cpu)]}
    res = {"calls": len(card), "items": 0, "max_rel": 0.0, "over_tol": 0, "differ": 0,
           "worst": []}
    worst = []
    for c, (a, b) in enumerate(zip(card, cpu)):
        x, y = a["out"], b["out"]
        res["items"] += len(x)
        keep = (x > floor) | (y > floor)
        rel = np.where(keep, np.abs(x - y) / np.maximum(1.0, np.abs(y)), 0.0)
        res["max_rel"] = max(res["max_rel"], float(rel.max(initial=0.0)))
        res["over_tol"] += int((rel > tol).sum())
        res["differ"] += int((x != y).sum())
        for i in np.argsort(-rel)[:3]:
            if rel[i] > 0:
                worst.append((float(rel[i]), c, int(i)))
    # neighbouring items of one read (its alleles): a tie on one device only
    # decides whether the realigner keeps the read
    flips = []
    for c, (a, b) in enumerate(zip(card, cpu)):
        reads, x, y = a["items"][1], a["out"], b["out"]
        for i in range(len(x) - 1):
            if reads[i] == reads[i + 1] and (x[i] == x[i + 1]) != (y[i] == y[i + 1]):
                flips.append({"call": c, "items": [i, i + 1], "card": [x[i], x[i + 1]],
                              "cpu": [y[i], y[i + 1]]})
    res["tie_flips"], res["tie_flip_items"] = len(flips), flips[:5]
    for r, c, i in sorted(worst, reverse=True)[:5]:
        call = card[c]
        alleles, reads, quals = (v[i:i + 1] for v in call["items"])
        alone = phc.forward_items(alleles, reads, [np.frombuffer(q, np.uint8) for q in quals],
                                  call["gap"], "cuda", call["general"], hop=call["hop"])
        res["worst"].append({"rel": r, "call": c, "item": i, "alen": len(alleles[0]),
                             "rlen": len(reads[0]), "card": float(call["out"][i]),
                             "cpu": float(cpu[c]["out"][i]), "card_alone": float(alone[0])})
    return res


def reads_of(obs, i):
    """(prob_alt, prob_ref) of record i's reads, as stored (float16)."""
    from varlociraptor_tpu_torch.ops.compact_obs import CF_PA, CF_PR

    _, counts, cols, _ = obs
    off, n = int(counts[:i].sum()), int(counts[i])
    f = cols.f16[off:off + n].astype(float)
    return [[float(a), float(r)] for a, r in zip(f[:, CF_PA], f[:, CF_PR])]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--world", help="reuse this earlier --work's world and properties")
    ap.add_argument("--genome-len", type=int, default=1_500_000)
    ap.add_argument("--homopolymer", action="store_true",
                    help="a homopolymer world, preprocessed in --pairhmm-mode homopolymer")
    ap.add_argument("--n-cpu", type=int, default=192)
    ap.add_argument("--card-runs", type=int, default=2)
    ap.add_argument("--samples", default="normal,tumor")
    ap.add_argument("--items", action="store_true",
                    help="also run the head on the card and hold the column route's "
                         "results to the CPU's item by item")
    args = ap.parse_args()

    import contextlib
    import io

    import numpy as np

    from varlociraptor_tpu_torch import _build, cli
    from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu_torch.compare import _read_observations, compare_observation_files
    from varlociraptor_tpu_torch.estimation.alignment_properties import AlignmentProperties

    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _build.load()
    w, props_path, homopolymer = world_and_props(args, work)
    mode = "homopolymer" if homopolymer else "exact"
    print(json.dumps({"root": str(ROOT), "mode": mode, "candidates": w["n_candidates"],
                      "setup_s": time.perf_counter() - t0}), flush=True)
    head = work / f"candidates_{args.n_cpu}.vcf"
    with open(w["candidates"]) as f, open(head, "w") as out:
        n = 0
        for line in f:
            if not line.startswith("#"):
                if n == args.n_cpu:
                    break
                n += 1
            out.write(line)
    props = AlignmentProperties.from_json(props_path.read_text())
    for sample in args.samples.split(","):
        res = {"sample": sample, "card_s": [], "launches": []}
        card = []
        for run in range(args.card_runs):
            path = work / f"{sample}.cuda{run}.obs"
            before = launch_counts()
            t1 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = cli.run(["preprocess", "variants", w["fasta"], "--bam", w[sample],
                              "--candidates", w["candidates"], "--output", str(path),
                              "--sample-name", sample, "--alignment-properties",
                              str(props_path), "--device", "cuda",
                              "--pairhmm-mode", mode])
            if rc != 0:
                raise SystemExit(f"preprocess returned {rc}")
            res["card_s"].append(time.perf_counter() - t1)
            res["launches"].append({k: v - before[k] for k, v in launch_counts().items()})
            card.append(path)
        cpu = work / f"{sample}.cpu.obs"
        logs = {}
        for dev in ("cuda", "cpu") if args.items else ("cpu",):
            undo = recording_items(logs.setdefault(dev, []))
            try:
                preprocess(str(head), w[sample], w["fasta"], str(work / f"{sample}.{dev}.obs"),
                           sample_name=sample, alignment_properties=props,
                           options=PreprocessOptions(device_chunk=64, log_mode="silent",
                                                     pairhmm_mode=mode),
                           device=dev)
            finally:
                undo()
        if args.items:
            res["items"] = compare_items(logs["cuda"], logs["cpu"])
        obs = [_read_observations(p, args.n_cpu) for p in card] + [_read_observations(cpu)]
        whole = [_read_observations(p) for p in card]
        res["card_runs_equal"] = all(
            np.array_equal(o[1], whole[0][1])
            and np.array_equal(o[2].f16, whole[0][2].f16, equal_nan=True)
            for o in whole[1:])
        res["problems"], info = compare_observation_files(cpu, card[0], n=args.n_cpu)
        res["max_rel"] = info.get("max_rel")
        differ = np.nonzero(obs[-1][1] != obs[0][1])[0].tolist()
        res["records_differing"] = differ
        res["detail"] = []
        for i in differ[:4]:
            v = obs[0][0][i]
            res["detail"].append({
                "record": i, "pos": v.pos, "kind": v.kind, "ref": v.ref_allele[:24],
                "alt": v.alt_allele[:24], "card_reads": reads_of(obs[0], i),
                "cpu_reads": reads_of(obs[-1], i)})
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
