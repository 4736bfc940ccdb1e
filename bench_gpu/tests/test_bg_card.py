"""On the card, at each cell's own size: over three seeds the program's
readings stay within the cell's limits and the control's do not (the
readings the limits were set from, ``calibrate.py``). Marked ``card``;
skips without a CUDA device.

    python -m pytest bench_gpu/tests/test_bg_card.py -m card
"""

import json
import subprocess
import sys

import pytest

from bench_gpu.harness import checks, common

CELLS = [w["name"] for w in common.benchmark()["workloads"]]
SEEDS = "7100001,7100002,7100003"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_beyond_the_limits(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench_gpu/calibrate.py", "--workload", cell,
         "--seeds", SEEDS, "--control", "3"], capture_output=True, text=True,
        timeout=3000, cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    limits = common.workload(cell)["limits"]
    lines = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert checks.judge(line["program"], limits)[0], line
        assert not checks.judge(line["control"], limits)[0], line
