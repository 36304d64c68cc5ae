#!/usr/bin/env python3
"""``chip_smoke.py``'s multi-process phases with one rank per visible GPU,
over NCCL: the dp ranks (an Adam and an Adam8bit step of the
data-parallel trainer at full width against one process on the same
global batch and draws, the optimizer state's bytes per rank), the sp
ranks (the edit's 16-frame window and a follow-up with the frames split
over the ranks, and one video a rank, against the unsharded windows), then
``apps/train.py`` as one process per rank. The same gates as
``chip_smoke.py``'s dp and sp phases, where two ranks share one card over
gloo.

    python3 tools/torch_multi_gpu.py     # on a machine with several H100s
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    from insv2v_torch.parallel.dist import spawn

    world = torch.cuda.device_count()
    if world < 2:
        sys.exit(f"torch_multi_gpu: {world} GPU(s); it runs one rank per card on several")
    chip_smoke.RANKS = world
    smi = chip_smoke.phase_env()
    t0 = time.perf_counter()
    ranks = spawn(chip_smoke._rank_main, world, ("dp", "sp"), 0, one_card_each=True,
                  timeout_s=900)
    chip_smoke.log(f"ranks: {world} processes, one per card ({smi}), "
                   f"{time.perf_counter() - t0:.1f} s in all")
    chip_smoke.report_ranks(ranks, ("dp", "sp"))
    chip_smoke.phase_dp_cli(argparse.Namespace(seed=0))
    print(f"torch_multi_gpu: {world} ranks ok", flush=True)


if __name__ == "__main__":
    main()
