"""Host seconds of one ``save_gif`` call (``media.save_gif``: the pair's
new video written as a looping GIF through Pillow, one call a pair), the
median over the run's calls."""

from program_spans import host_ms, per_record, snapshot

LAYER = "media (utils/media.py)"
UNIT, BETTER, SOURCE, MOVES = "s", "lower", "program_span", "datagen_pairs_per_min"


def value(snap):
    ms = per_record(snap, "media.save_gif", host_ms)
    return None if ms is None else ms / 1e3


def read(r):
    return value(snapshot())
