"""The plain reference against the port for each cell's entry, and each
fault the cell can have planted in the timed path, at a size the CPU holds:
sound runs come out correct, broken ones not."""

import pytest

from benchmark.tests import tiny

FAULTS = {"goal_1_view.infer": ["state_unchanged", "answer_altered",
                                "guesses_stale", "bias_dropped"],
          "nerf_1_view_wo.view": ["answer_altered", "half_batch",
                                  "bias_dropped"],
          "nerf_1_view_wo.train": ["state_unchanged", "half_batch",
                                   "answer_altered"]}


@pytest.mark.parametrize("name", tiny.CELLS)
def test_reference_agrees_with_the_port(name, monkeypatch):
    tiny.keep_fault_targets(monkeypatch)
    result = tiny.run(name)
    assert result.failed == 0 and result.attempted >= 1
    assert result.checks and result.correct, result.checks


@pytest.mark.parametrize("name,fault", [(n, f) for n in tiny.CELLS
                                        for f in FAULTS[n]])
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    tiny.keep_fault_targets(monkeypatch)
    result = tiny.run(name, faults=[fault])
    assert not result.correct, (fault, result.checks)
    assert any(c["value"] > c["limit"] for c in result.checks.values())


def test_minority_of_guesses_fails_the_share(monkeypatch):
    """Three eighths of the guesses left at their initial poses leave the
    median gap within its limit; the share of guesses off catches it."""
    tiny.keep_fault_targets(monkeypatch)
    result = tiny.run("goal_1_view.infer", faults=["guesses_stale"])
    checks = result.checks
    assert checks["energy_gap_median"]["value"] <= \
        checks["energy_gap_median"]["limit"], checks
    share = checks["energy_share_off_0.001"]
    assert share["value"] > share["limit"], checks


def test_train_check_covers_window_steps(monkeypatch):
    """The train check replays the warm-up and the window's first steps,
    and a fault planted at the window's start, after the warm-up, fails."""
    tiny.keep_fault_targets(monkeypatch)
    sound = tiny.run("nerf_1_view_wo.train")
    assert sound.info["window_steps"] >= 1 and sound.correct
    broken = tiny.run("nerf_1_view_wo.train", faults=["state_unchanged"])
    assert broken.checks["change_gap"]["value"] > 0.5, broken.checks
