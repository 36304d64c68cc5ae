#!/usr/bin/env python3
"""Faults planted in the motion-compensated edit's program for the readings
its ``flow`` limit is set from, and for the CPU tests, in ``faults.py``'s
form: each returns ``(owner, attribute, replacement)``. Run as a script,
``calibrate.py`` with these faults among its ``--fault`` choices:

    python3 benchmark/faults_flow.py --workload insv2v.edit-flow-raft-32f-384-ddpm20 \
        --seeds 11 --control 0 --fault lookup_swap
"""

from __future__ import annotations

import sys


def lookup_swap():
    """RAFT's correlation lookup with the x and y offsets of its window
    swapped: channel a*(2r+1) + b of a level holds the sample at offset
    (b - r, a - r) where it should hold (a - r, b - r)."""
    from insv2v_torch.models import raft

    real = raft.corr_lookup

    def swapped(pyramid, coords, radius):
        out = real(pyramid, coords, radius)
        b, h, w, _ = out.shape
        k = 2 * radius + 1
        return out.reshape(b, h, w, -1, k, k).transpose(-1, -2).reshape(b, h, w, -1)

    return raft, "corr_lookup", swapped


FAULTS = {"lookup_swap": lookup_swap}

if __name__ == "__main__":
    import faults

    faults.FAULTS.update(FAULTS)
    import calibrate

    sys.exit(calibrate.main())
