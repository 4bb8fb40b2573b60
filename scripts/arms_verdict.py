"""The verdict on two arms of `dngf_convergence_cpu` fits, the port on the
card (C) and on the CPU (P): how many runs of each hold a validation scene
whose strong top-1 error is above 200 mm, and the one-sided Fisher exact p
that the card flags more often. The 200 mm line is part of the rule, fixed
before the runs it judged.

    python scripts/arms_verdict.py <first seed> <last seed> \\
        [--dir build/dngf_arms] [--tag strong|strong_alternate]

reads `<dir>/<arm><seed>.<tag>.err`, the standard error of a run's score:

    python -m tcnerf_torch.tools.convergence --strong <dir>/<arm><seed> \\
        --backbone <dir>/backbone --config dngf_convergence_cpu \\
        device=cpu seed=<seed> data_dir=<dir>/data --bar

(`strong`; with scripts/strong_alternate.py in place of `-m ...`, the
`strong_alternate` tag). `session.validate` logs each validation scene's
top-1 error ("Best <mm> <deg>" after "Validating on sample <i>"), first
for the trained `best`, then for the untrained readout; the trained scenes
are the ones before the first "Average" line. Exits 1 if a run's log is
missing or its trained block is not complete."""

import argparse
import os
import re
import sys

ARMS = ("C", "P")   # (card, CPU): the test asks whether the first flags more
LIMIT_MM = 200.0

_SCENE = re.compile(r"Validating on sample (\d+) ")
_BEST = re.compile(r"\s{3}Best\s{4}(\S+)\s+(\S+)\s*$")


def trained_scenes(text: str):
    """The trained readout's per-scene strong top-1 translational errors
    (mm), in scene order, from a score log; empty until the log holds the
    trained block's "Average" line (a scoring still running)."""
    errors, pending = [], False
    for line in text.splitlines():
        if "   Average   " in line:
            return errors
        if _SCENE.search(line):
            pending = True
            continue
        match = _BEST.search(line)
        if pending and match:
            errors.append(float(match.group(1)))
            pending = False
    return []


def fisher_p(card_flagged: int, card_runs: int, cpu_flagged: int,
             cpu_runs: int) -> float:
    """One-sided Fisher exact p that the card's share of flagged runs
    exceeds the CPU's."""
    from scipy.stats import fisher_exact

    table = [[card_flagged, card_runs - card_flagged],
             [cpu_flagged, cpu_runs - cpu_flagged]]
    return float(fisher_exact(table, alternative="greater")[1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("first", type=int)
    parser.add_argument("last", type=int)
    parser.add_argument("--dir", default="build/dngf_arms")
    parser.add_argument("--tag", default="strong",
                        choices=("strong", "strong_alternate"))
    args = parser.parse_args(argv)
    seeds = range(args.first, args.last + 1)
    counts, ok = {}, True
    print(f"{args.tag}: runs with a validation scene above {LIMIT_MM:g} mm "
          f"(trained strong top-1, mm per scene)")
    for arm in ARMS:
        flagged = runs = 0
        for s in seeds:
            path = os.path.join(args.dir, f"{arm}{s}.{args.tag}.err")
            scenes = []
            if os.path.exists(path):
                with open(path) as f:
                    scenes = trained_scenes(f.read())
            if not scenes:
                print(f"  {arm}{s}: no scored scenes in {path}")
                ok = False
                continue
            hit = any(e > LIMIT_MM for e in scenes)
            flagged += hit
            runs += 1
            print(f"  {arm}{s}: " + " / ".join(f"{e:.2f}" for e in scenes)
                  + (" *" if hit else ""))
        counts[arm] = (flagged, runs)
    (cf, cn), (pf, pn) = counts["C"], counts["P"]
    print(f"card {cf} of {cn}, CPU {pf} of {pn}; one-sided Fisher p "
          f"(card > CPU) = {fisher_p(cf, cn, pf, pn):.4f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
