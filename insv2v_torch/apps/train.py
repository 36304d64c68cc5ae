"""Training CLI of the port: the motion modules on one GPU.

    python -m insv2v_torch.apps.train --config configs/instruct_v2v.yaml -r

Counterpart of ``apps/train.py`` in the JAX package, in one process:
builds the models and the dataset from the YAML, loads the initial
weights the config names (the SD/ip2p UNet merged with the AnimateDiff
motion weights, the VAE, the text encoder) or runs on seeded random ones
with ``--allow-random-weights``, then trains with gradient accumulation,
motion-only updates, a jsonl metric stream, checkpoints and resume. The
model computes in bf16 on the GPU (``--device cuda``, the default) and in
float32 on the CPU (``--device cpu``). Multi-process data parallelism
(the JAX package's dp mesh with ZeRO-2) is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("-r", "--resume", action="store_true",
                   help="resume from the newest checkpoint in the experiment directory")
    p.add_argument("--ckpt", default=None, help="an explicit checkpoint to resume from")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--allow-random-weights", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


class JsonlLogger:
    """Metric sink: one JSON record per line (wandb-compatible fields)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def log(self, record: dict):
        self.f.write(json.dumps(record) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def batch_iterator(dataset, batch_size: int, prompt_type: str, tokenizer, rng):
    """Random samples stacked into batches of numpy arrays; the prompt key
    as the reference's get_prompt picks it (edit, output, or mixed)."""
    import numpy as np

    if len(dataset) == 0:
        raise ValueError("the training dataset is empty")
    while True:
        items = [dataset[int(i)] for i in rng.randint(0, len(dataset), size=batch_size)]
        if prompt_type == "mixed_prompt":
            key = "output_prompt" if rng.rand() > 0.5 else "edit_prompt"
        else:
            key = prompt_type
        yield {
            "input_video": np.stack([it["input_video"] for it in items]).astype(np.float32),
            "edited_video": np.stack([it["edited_video"] for it in items]).astype(np.float32),
            "prompt_ids": np.asarray(tokenizer([it[key] for it in items])),
        }


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from insv2v_torch._device import resolve_device
    from insv2v_torch.data.datasets import dataset_from_config
    from insv2v_torch.text.tokenizer import get_tokenizer
    from insv2v_torch.training.trainer import TrainConfig, Trainer
    from insv2v_torch.utils.checkpoint import (load_into, load_pipeline_state_dicts,
                                               restore_train_state, save_train_state)
    from insv2v_torch.utils.config import load_config
    from insv2v_torch.utils.factory import build_models

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    tr = cfg["trainer"]
    expt_dir = os.path.join(cfg.get("expt_dir", "experiments"), cfg.get("expt_name", "run"))
    os.makedirs(expt_dir, exist_ok=True)

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    models = build_models(cfg, device=dev, dtype=dtype, seed=args.seed)
    init = cfg.get("init_weights", {})
    present = lambda p: p if p and os.path.exists(p) else None
    unet_w = list(init.get("unet") or []) + [None, None]
    sds = load_pipeline_state_dicts(
        unet_weights=present(unet_w[0]), motion_weights=present(unet_w[1]),
        vae_weights=present(init.get("vae")), text_weights=present(init.get("text_model")))
    missing = {"unet", "vae", "text"} - set(sds)
    if missing and not args.allow_random_weights:
        sys.exit(f"missing init weights for {sorted(missing)}; pass "
                 f"--allow-random-weights for a smoke run")
    load_into(models, sds)

    tcfg = TrainConfig(
        lr=float(tr.get("lr", 1e-5)), loss_type=tr.get("loss_fn", "l2"),
        cond_image_dropout=float(tr.get("cond_image_dropout", 0.1)),
        scale_factor=float(tr.get("scale_factor", 0.18215)),
        accumulate_grad_batches=int(tr.get("accumulate_grad_batches", 1)),
        **{k: v for k, v in cfg.get("diffusion", {}).items()
           if k in ("beta_schedule", "num_train_timesteps", "beta_start", "beta_end")})
    trainer = Trainer(models["unet"], models["vae"], models["text_model"], tcfg)
    state = trainer.create_state()
    if args.ckpt or args.resume:
        try:
            state = restore_train_state(args.ckpt or expt_dir, state)
            trainer.push_params(state)
            print(f"resumed at step {state.step}")
        except FileNotFoundError:
            if args.ckpt:
                raise
            print("no checkpoint found; starting fresh")

    micro = int(tr.get("micro_batch_size", 1))
    batches = batch_iterator(dataset_from_config(cfg["data"]["train"]),
                             tcfg.accumulate_grad_batches * micro,
                             tr.get("prompt_type", "edit_prompt"), get_tokenizer(),
                             np.random.RandomState(args.seed + state.step))
    gen = torch.Generator(device=dev).manual_seed(args.seed + state.step)
    max_steps = args.max_steps or int(tr.get("max_steps", 1000))
    ckpt_every = int(tr.get("checkpoint_every", 1000))
    val_every = int(tr.get("val_every", 0))
    validate = None
    if val_every:
        from insv2v_torch.training.validation import make_validation_fn, save_preview_grid

        validate = make_validation_fn(
            trainer, num_steps=int(cfg.get("diffusion", {}).get("ddim_sampling_steps", 20)),
            text_cfg=float(tr.get("text_cfg", 7.5)), img_cfg=float(tr.get("img_cfg", 1.2)))

    logger = JsonlLogger(os.path.join(expt_dir, "metrics.jsonl"))
    try:
        while state.step < max_steps:
            t0 = time.perf_counter()
            batch = next(batches)
            state, metrics = trainer.train_step(state, batch, gen)
            dt = time.perf_counter() - t0
            logger.log({"step": state.step, "train_loss": metrics["train_loss"],
                        "step_time_s": dt})
            print(f"step {state.step}: loss={metrics['train_loss']:.4f} ({dt:.1f}s)")
            if validate is not None and state.step % val_every == 0:
                vb = {k: v[:micro] for k, v in batch.items()}
                out = validate(vb, gen)
                path = save_preview_grid(vb, out["pred"].cpu().numpy(),
                                         os.path.join(expt_dir, "previews"), state.step,
                                         trajectory=out["trajectory"].cpu().numpy())
                logger.log({"step": state.step, "preview": path})
            if state.step % ckpt_every == 0 or state.step >= max_steps:
                print(f"checkpointed {save_train_state(state, expt_dir)}")
    finally:
        logger.close()


if __name__ == "__main__":
    main()
