"""The device's idle share in a 4-way phase-1 UNetSD step: 1 - (device-busy ms a step,
the union of the device operations' intervals over the profiled
stretch) / (wall ms a step in the traced window, from the sampler's
synchronised spans). The stretch's own span is not the denominator: the
profiler's host overhead would count as idle."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "datagen_pairs_per_min"


def read(r):
    return r.idle_share()
