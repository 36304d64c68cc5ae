"""Peak device memory of the run to the window's end, in GiB (the
allocator's counter)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "GiB", "lower", "program_counter", "edit_fps"


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
