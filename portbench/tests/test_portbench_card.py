"""The command on a card: each one-card cell runs a short window and comes
out correct, and the result line names the card. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct_on_a_card(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "3", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=run.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["device"]["kind"] == card
    assert got["device"]["platform"] == "gpu" and got["device"]["count"] == 1


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """Here, where torch sees no card: exit 3 and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         ONE_CARD[0], "--seed", "1", "--seconds", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=run.ROOT, TMPDIR=str(tmp_path)))
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("visible,chips,want", [
    (None, 1, "0"), (None, 4, "0,1,2,3"), ("2,3,5", 1, "2"),
    ("0,1,2,3,4,5,6,7", 4, "0,1,2,3"), ("1", 4, "1"), ("", 1, ""),
])
def test_a_cell_sees_only_the_cards_it_asks_for(visible, chips, want):
    assert run.visible_cards(visible, chips) == want
