"""The measurement path needs the card: without one it fails and prints no
result. The cell itself runs only on the card (marked `cuda`)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import settings


def _run(args, env=None, cwd=None):
    return subprocess.run([sys.executable, str(settings.HERE / "run.py"), *args], capture_output=True, text=True,
                          timeout=600, env=env, cwd=cwd or str(settings.ROOT))


def test_without_a_card_it_fails_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["--workload", "vo-clip257", "--seed", "1", "--seconds", "1", "--trace", "0"], env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_an_unknown_cell_fails():
    out = _run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda):
    out = _run(["--workload", "vo-clip257", "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"])
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
