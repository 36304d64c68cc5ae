"""Peak device memory of rank 0 (its card) to the window's end, in GiB
(the allocator's counter)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "GiB", "lower", "program_counter", "train_frames_per_s"


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
