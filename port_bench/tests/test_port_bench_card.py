"""The control of `correct` on the card: the TUM cell at its own size
(a window of the least three shape periods), once as the program runs it
and once with its TF32 path on (TF32 matmuls and cuDNN: the nearest
precision below the configuration's float32), which must come out not
correct.  Needs an NVIDIA GPU and skips without one:

    python -m pytest -m cuda port_bench/tests/test_port_bench_card.py
"""

import pytest
import torch

from port_bench.harness import cell as cell_mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True], ids=["program", "tf32_control"])
def test_the_control_is_not_correct(card, control):
    run = cell_mod.run(cell_mod.load_cell("tum_rgbd_dsp.shapes"), 8000000001, 1.0, False, control=control)
    detail = {k: (run["numbers"].get(k), v) for k, v in run["limits"].items()}
    assert run["correct"] is (not control), detail
