"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (a CPU run at a tiny size) and
each fault of `harness/faults.py` is planted beneath the hooks in turn.
The cells run on one card, so no exchange between chips can be left out."""

import pytest

from port_bench.harness import faults
from port_bench_tiny import tiny_run


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_planted_fault_is_not_correct(fault):
    run = tiny_run("tum_rgbd_dsp.shapes", seed=7, fault=faults.make(fault))
    assert not run["correct"], {k: (run["numbers"].get(k), v) for k, v in run["limits"].items()}


def test_the_same_run_without_a_fault_is_correct():
    assert tiny_run("tum_rgbd_dsp.shapes", seed=7)["correct"]


def test_settings_other_than_the_configurations_are_counted():
    """The shape step's LM and decoder settings are held to the
    configuration file's, and its hypotheses to due objects x flips."""
    from port_bench.harness import cell as cell_mod
    from port_bench.harness import checks, setup
    from qsp_slam_tpu_torch.models.deepsdf import DeepSDFConfig
    from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig

    cfg = cell_mod.load_cell("tum_rgbd_dsp.shapes")["config"]
    opt, dec = setup.shape_opt(cfg), setup.decoder_shape(cfg)
    step = {"opt_cfg": ShapeOptConfig(**opt), "dec_cfg": DeepSDFConfig(**dec), "hyps": 3 * opt["num_flips"]}
    assert checks._settings_mismatch(step, opt, dec, 3) == 0
    assert checks._settings_mismatch(dict(step, opt_cfg=ShapeOptConfig(**dict(opt, iters=1))), opt, dec, 3) == 1
    assert checks._settings_mismatch(dict(step, opt_cfg=ShapeOptConfig(**dict(opt, w_render=0.0))), opt, dec, 3) == 1
    assert checks._settings_mismatch(dict(step, dec_cfg=DeepSDFConfig(**dict(dec, num_layers=8))), opt, dec, 3) == 1
    assert checks._settings_mismatch(dict(step, hyps=3), opt, dec, 3) == 1
