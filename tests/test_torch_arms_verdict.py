"""scripts/arms_verdict.py, Queue C's count of the delta-NGF arms: the
per-scene strong top-1 errors read from the arms' score logs, the runs
with a scene above 200 mm per arm, and the one-sided Fisher exact p."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _verdict():
    spec = importlib.util.spec_from_file_location(
        "scripts_arms_verdict", os.path.join(REPO, "scripts",
                                             "arms_verdict.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _log(trained, untrained):
    """A score log as `session.validate` and `log_results` write it under
    the tool's logging format: the trained scenes, their averages, then
    the untrained scenes."""
    lines = []
    for block in (trained, untrained):
        for i, mm in enumerate(block):
            lines += [f"2026-01-01 00:00:00,000 INFO Validating on sample "
                      f"{i + 1} with 1 objects ...",
                      f"2026-01-01 00:00:00,000 INFO    Best    {mm}    "
                      f"97.5"]
        lines += ["2026-01-01 00:00:00,000 INFO    Average   80.0    90.0",
                  f"2026-01-01 00:00:00,000 INFO    Best   {max(block)}    "
                  f"90.0"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("counts,p", [
    ((4, 9, 0, 12), 0.0211), ((3, 9, 3, 12), 0.523), ((4, 10, 0, 10), 0.0433),
    ((3, 10, 0, 10), 0.1053)],
    ids=["seeds-0-5-sync", "seeds-0-5-alternate", "ten-four-zero", "ten-three-zero"])
def test_fisher_p_of_the_counts(counts, p):
    """The counts of the arms' seeds 0-5 (card 4 of 9 against CPU 0 of 12
    under the trainer's ascent, 3 of 9 against 3 of 12 under the JAX
    tool's) give p = 0.0211 and 0.523; on ten runs an arm, 4 against 0 is the least card excess
    below 0.05."""
    assert _verdict().fisher_p(*counts) == pytest.approx(p, abs=5e-4)


def test_trained_scenes_stop_at_the_first_average():
    """Only the trained readout's scenes count, in scene order; the
    averages' "Best" line and the untrained scenes do not; a log cut
    before the trained block's averages (a scoring still running) has no
    scenes."""
    text = _log([34.5, 250.25, 20.0, 41.0], [300.0, 400.0, 280.0, 500.0])
    tool = _verdict()
    assert tool.trained_scenes(text) == [34.5, 250.25, 20.0, 41.0]
    cut = text[:text.index("Validating on sample 3")]
    assert tool.trained_scenes(cut) == []


def test_verdict_counts_each_arm(tmp_path, capsys):
    """Runs with a scene above 200 mm are counted per arm over the seed
    range, printed with their scenes, and the p is printed; a missing log
    is named and makes the exit code 1."""
    logs = {"C6": [30.0, 210.0, 20.0, 40.0], "C7": [30.0, 25.0, 20.0, 40.0],
            "P6": [30.0, 199.0, 20.0, 40.0], "P7": [30.0, 25.0, 20.0, 40.0]}
    for run, scenes in logs.items():
        (tmp_path / f"{run}.strong.err").write_text(
            _log(scenes, [300.0] * 4))
    tool = _verdict()
    assert tool.main(["6", "7", "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "C6: 30.00 / 210.00 / 20.00 / 40.00 *" in out
    assert "P6: 30.00 / 199.00 / 20.00 / 40.00\n" in out
    assert "card 1 of 2, CPU 0 of 2" in out
    assert f"p (card > CPU) = {tool.fisher_p(1, 2, 0, 2):.4f}" in out
    assert tool.main(["6", "8", "--dir", str(tmp_path)]) == 1
    assert "C8: no scored scenes" in capsys.readouterr().out
