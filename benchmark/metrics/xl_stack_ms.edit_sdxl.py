"""Device milliseconds a 3-way UNet call spends in the spatial transformer
stacks of the deepest level (depth 10 at 1280 channels: two in the down
block, the mid block's, three in the up block): the program's
``unet.stack.l<level>`` spans, whose device intervals the editor's
``timings`` ask for, summed over each edit of the traced window and over
its UNet calls (``sampler.unet``); the median over the edits. A program
without such spans reads nothing."""

import statistics

LAYER = "model (models/unet3d.py, models/modelscope_t2v.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "edit_fps"
LEVEL = 2  # the deepest level of insv2v-sdxl-animatediff's three


def value(snap):
    if snap is None:
        return None
    kept = lambda rec: not (rec.profiled or rec.failed)
    ms, calls = {}, {}
    for rec in snap["spans"].get(f"unet.stack.l{LEVEL}", []):
        if kept(rec) and rec.dev_start_ns is not None:
            ms[rec.unit] = ms.get(rec.unit, 0.0) + (rec.dev_end_ns - rec.dev_start_ns) / 1e6
    for rec in snap["spans"].get("sampler.unet", []):
        if kept(rec) and rec.unit in ms:
            calls[rec.unit] = calls.get(rec.unit, 0) + 1
    values = [v / calls[u] for u, v in ms.items() if calls.get(u)]
    return statistics.median(values) if values else None


def read(r):
    from program_spans import snapshot

    return value(snapshot())
