"""The port's strong validation of a grasp run with the ascent of
tools/strong_goal_validation.py: the t and r phases in turn for every
family (the JAX tool sets no `sync`), where the port's tool takes the
family's trainer's ascent (a delta-NGF run's synchronized).

    python scripts/strong_alternate.py --strong <model_path> \\
        --backbone <dir> --config <grasp config> [key=value ...] \\
        [--bar] [--ratio 0.5]

takes the arguments of `python -m tcnerf_torch.tools.convergence` and
prints what it prints, the JAX record's strong-ascent error included
(that ascent produced it). scripts/arms_verdict.py reads its logs of
the delta-NGF arms under the `strong_alternate` tag."""

import contextlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@contextlib.contextmanager
def in_turn():
    """`tcnerf_torch.tools.convergence` with every family's strong ascent
    taking the t and r phases in turn."""
    from tcnerf_torch.tools import convergence

    sync = convergence.strong_sync
    convergence.strong_sync = lambda config: False
    try:
        yield convergence
    finally:
        convergence.strong_sync = sync


def main(argv):
    with in_turn() as convergence:
        return convergence.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
