"""Multi-process smoke check: one data-parallel training step.

Run one process per rank, on the CPU or sharing one GPU, over gloo:

    python -m insv2v_torch.parallel.multihost_check 0 2 29500 --device cpu &
    python -m insv2v_torch.parallel.multihost_check 1 2 29500 --device cpu

Counterpart of ``parallel/multihost_check.py`` in the JAX package: the
tiny models from one seed on every process, the same global batch (accum
2 x micro 1 per rank) on every process with each rank training on its
share of it (``local_batch_slice``), one Adam step through the
data-parallel ``Trainer`` with the optimizer state sharded over the
ranks. It asserts that the state really is sharded
(``assert_zero_sharded``) and that every rank holds the same updated
motion masters, and prints ``MULTIHOST_OK process=i/n loss=<x>`` (the
same loss on every process). On the GPU (the default) the ranks share the
first one and the models are bf16, with the UNet's widths at 320 (the
widths the kernels are compiled for) so its FFs and motion attention run
kernels B and C.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["run", "main"]

# the tiny UNet at the SD widths of kernels B (320) and C (head dim 40)
_KERNEL_WIDTHS = dict(block_out_channels=(320,) * 4, attention_head_dim=8,
                      motion_num_attention_heads=8, norm_num_groups=32)


def run(process_id: int, num_processes: int, port: int, device=None) -> float:
    import numpy as np
    import torch
    import torch.distributed as dist

    from insv2v_torch._device import resolve_device
    from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
    from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
    from insv2v_torch.parallel.dist import (Group, assert_zero_sharded, init_distributed,
                                            local_batch_slice, local_device,
                                            same_on_all_ranks)
    from insv2v_torch.training.trainer import TrainConfig, Trainer

    torch.set_num_threads(1)
    dev = resolve_device(device)
    init_distributed(f"127.0.0.1:{port}", num_processes, process_id, backend="gloo",
                     device=dev)
    try:
        group = Group()
        dev = local_device(dev)
        torch.manual_seed(0)
        widths = {} if dev.type == "cpu" else _KERNEL_WIDTHS
        with torch.device(dev):
            unet = UNet3DConditionModel(UNetConfig.tiny(in_channels=8, out_channels=4,
                                                        **widths))
            vae = AutoencoderKL(VaeConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1,
                                          z_channels=4, embed_dim=4, resolution=16))
            clip = ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=12, num_layers=1,
                                                  num_heads=2, intermediate_size=24))
        if dev.type == "cuda":
            unet, vae, clip = (m.to(torch.bfloat16) for m in (unet, vae, clip))
        accum = 2
        trainer = Trainer(unet, vae, clip, TrainConfig(accumulate_grad_batches=accum),
                          group=group)
        state = trainer.create_state()
        n_total = accum * num_processes  # micro-batch 1 per rank
        rs = np.random.RandomState(0)
        full = {"input_video": rs.randn(n_total, 2, 16, 16, 3).astype(np.float32),
                "edited_video": rs.randn(n_total, 2, 16, 16, 3).astype(np.float32),
                "prompt_ids": rs.randint(0, 64, (n_total, 77)).astype(np.int64)}
        local = local_batch_slice(full, accum, group.rank, group.size)
        gen = torch.Generator(device=dev).manual_seed(1 + group.rank)
        state, metrics = trainer.train_step(state, local, gen)
        loss = metrics["train_loss"]
        if not np.isfinite(loss) or state.step != 1:
            raise AssertionError(f"step {state.step}: loss {loss}")
        assert_zero_sharded(state.optimizer, group)
        if not same_on_all_ranks(list(state.params.values()), group):
            raise AssertionError("the ranks hold different motion masters after the step")
        return loss
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("port", type=int)
    p.add_argument("--device", default=None, help="cuda (default; the ranks share it) or cpu")
    args = p.parse_args(argv)
    loss = run(args.process_id, args.num_processes, args.port, args.device)
    print(f"MULTIHOST_OK process={args.process_id}/{args.num_processes} loss={loss:.6f}",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
