"""The data-parallel training cell's harness at a tiny size on the CPU:
rank 0 in this process and one more rank started by the driver, over
gloo, through the driver's own rank code. A sound run passes every limit
with the ranks' masters equal; the planted fault that leaves the
gradient exchange out fails ``grad``. The driver's timeouts (the process
group's 60 s, the liveness check of the other rank every second) turn a
dead rank into a failure rather than a hang."""

from __future__ import annotations

import copy

import pytest
import torch

import tiny
from harness import Cell

DP = "insv2v.train-16f-256-acc8-dp4"


def tiny_dp_cell() -> Cell:
    cell = Cell.load(DP)
    small = tiny.tiny_train_cell()
    cfg = copy.deepcopy(small.config)
    cfg["dtype"] = "float32"
    traffic = dict(cell.traffic, size=64, accumulate=2, samples=4, ranks=2)
    return Cell(DP, dict(cell.spec), cfg, traffic)


@pytest.mark.parametrize("fault", [None, "no_exchange"], ids=["sound", "no_exchange"])
def test_two_ranks_over_gloo(fault, monkeypatch):
    cell = tiny_dp_cell()
    drv_mod = cell.driver()
    monkeypatch.setattr(drv_mod, "READY_S", 240)
    monkeypatch.setattr(drv_mod, "REPLY_S", 120)
    monkeypatch.setattr(drv_mod.Driver, "fault", fault)
    # two ranks share the CPU: a few threads each rather than all of them twice
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    drv = drv_mod.Driver(cell, 2 ** 31 + 7, "cpu")
    try:
        drv.setup()
        drv.run_unit(0)
        drv.release()
        prog, _ = drv.check()
    finally:
        torch.set_num_threads(threads)
        if drv.peers is not None:
            drv.peers.stop()
    limits = cell.spec["limits"]
    assert set(prog) == set(limits)
    assert prog["masters"] == 0.0 and prog["data"] == 0.0
    if fault is None:
        # float32 on both sides: the limits hold with room (they are set for bf16)
        assert all(v <= limits[k] for k, v in prog.items()), prog
    else:
        assert prog["grad"] > limits["grad"], prog
