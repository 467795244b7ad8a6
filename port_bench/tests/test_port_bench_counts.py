"""The yardstick's arithmetic against hand counts: the decoder FLOP a
shape step needs, and the least times of K1 and K2."""

import pytest

from port_bench.metrics import bounds, flop, peaks
from port_bench.reference.shape import layer_dims


def test_layer_dims_narrow_before_the_latent_layer():
    # code 2 + xyz 3 = 5 inputs, width 8, 3 layers, the input again before layer 2
    assert layer_dims(2, 8, 3, (2,)) == [(5, 8), (8, 3), (8, 1)]
    assert layer_dims(64, 512, 8, (4,)) == [(67, 512), (512, 512), (512, 512), (512, 445), (512, 512),
                                            (512, 512), (512, 512), (512, 1)]


def test_needed_flop_by_hand():
    dims = layer_dims(2, 8, 3, (2,))  # 5*8 + 8*3 + 8*1 = 72 multiply-adds per point
    assert flop.macs_per_point(dims) == 72
    assert flop.passes(2) == 9  # start cost + 2 x (forward, backward = 2 forwards, trial)
    # hypothesis 1: 3 valid points, 2 valid rays of 32 samples; hypothesis 2: 1 point, no ray
    got = flop.shape_step_flop(dims, 2, [([3, 1], [2, 0])])
    assert got == 2 * 72 * 9 * (3 + 64 + 1) == 88128


def test_needed_flop_at_the_published_width():
    # DeepSDF's specs: eight hidden layers of 512 and the output, 9 linear layers
    dims = layer_dims(64, 512, 9, (4,))
    macs = 67 * 512 + 512 * 512 * 6 + 512 * 445 + 512
    assert flop.macs_per_point(dims) == macs == 1835520
    # one hypothesis, 5 trips, 256 valid points and 256 valid rays
    assert flop.shape_step_flop(dims, 5, [([256], [256])]) == 2 * macs * 21 * (256 + 256 * 32)


def test_needed_flop_takes_the_configurations_trips():
    """The count follows the configured trips, not the ones the program
    passed to its LM, so a program that runs fewer trips reads a lower
    share and not an unchanged one."""
    import torch

    from port_bench.harness import checks
    from port_bench.harness.setup import decoder_dims

    class Opt:
        iters = 1

    cfg = {"DeepSDF.CodeLength": 2, "DeepSDF.dims": [8, 8], "DeepSDF.latent_in": [2]}
    args = [None] * 5 + [torch.tensor([[True, True, True], [True, False, False]])] + [None] * 2 + \
        [torch.tensor([[True, True, False], [False, False, False]])]
    steps = [{"chunks": [(args, None)], "opt_cfg": Opt()}, {"hyps": 0}]
    got = checks.needed_flop(steps, decoder_dims(cfg), 2)
    assert got == steps[0]["needed_flop"] == 2 * 72 * 9 * (3 + 64 + 1)


def test_k1_least_time_by_hand():
    b = bounds.k1_launch([(480, 640)], thresholds=2)
    assert b["operations"] == pytest.approx(140 * 307200 * 2 / 67e12)
    assert b["bytes"] == pytest.approx((4 * 307200 + 2 * 4 * 307200) / 3.35e12)
    # the 8-level 640x480 pyramid at both thresholds: 3.97 us, operation-bound
    shapes = [(int(round(480 / 1.2**i)), int(round(640 / 1.2**i))) for i in range(8)]
    b = bounds.k1_launch(shapes)
    assert max(b, key=b.get) == "operations"
    assert bounds.least_s(b) == pytest.approx(3.97e-6, rel=0.01)


def test_k2_least_time_by_hand():
    b = bounds.k2_launch(8192, 4000)
    assert b["bytes"] == pytest.approx(((8192 + 4000) * 32 + 8192 * 4000 * 4) / peaks.HBM_BYTES_S)
    assert b["operations"] == pytest.approx(2 * 8192 * 4000 * 256 / peaks.INT8_OPS_S)
    assert bounds.least_s(b) == pytest.approx(3.92e-5, rel=0.01)  # byte-bound, the (A, B) int32 write
