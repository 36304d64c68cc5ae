"""The references against the port at tiny sizes on the CPU, both in
float32 on the same weights: the driver's whole check of one unit (text,
VAE, every checked UNet step with its guidance, anchoring and DDIM
update, the decode, for data generation the prompt-to-prompt contexts
and the CLIP scores, for training the rebuilt batches, the losses, the
first gradient and the motion parameters' change) reads rounding alone."""

from __future__ import annotations

import copy

import pytest

import tiny

F32_TOL = 2e-4  # float32 against float32: orders of summation alone
# Adam's first steps move an element by about lr whatever its gradient's
# size, so elements whose gradient is at rounding flip their step's sign
CHANGE_TOL = 2e-3


@pytest.mark.parametrize("make", [tiny.tiny_edit_cell, tiny.tiny_datagen_cell,
                                  tiny.tiny_train_cell], ids=["edit", "datagen", "train"])
def test_reference_matches_the_port_in_float32(make):
    cell = make()
    cell.config = copy.deepcopy(cell.config)
    cell.config["dtype"] = "float32"
    drv = cell.driver().Driver(cell, 2 ** 31 + 5, "cpu")
    drv.setup()
    if drv.unit != "step":  # training's checked steps run in its set-up
        drv.run_unit(0)
    drv.release()
    prog, _ = drv.check()
    assert set(prog) == set(cell.spec["limits"])
    assert all(v < (CHANGE_TOL if k == "change" else F32_TOL) for k, v in prog.items()), prog
