"""Multi-process parallelism of the port over ``torch.distributed``.

``dist``: process groups, the one transport (``Group``), the data-parallel
batch layout, the optimizer state sharded over ranks and the frame-sharded
context; ``inference``: the frame- and batch-sharded window sampler;
``multihost_check``: a two-process rehearsal of one data-parallel step.
"""
