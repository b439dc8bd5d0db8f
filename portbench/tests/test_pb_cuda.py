"""On the card: one short run of each cell through the command the
checks use, correct, its last line the contract's."""
import json
import subprocess
import sys

import pytest

from portbench import bench


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["g16_2p20_serial", "ug_2p20_serial_u16"])
def test_short_run_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", "3000000001", "--seconds", "5",
                        "--trace", "0"], cwd=bench.HERE.parent,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
