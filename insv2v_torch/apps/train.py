"""Training CLI of the port: the motion modules, on one GPU or data-parallel.

    python -m insv2v_torch.apps.train --config configs/instruct_v2v.yaml -r
    python -m insv2v_torch.apps.train --config ... --coordinator 127.0.0.1:29500 \
        --num-processes 2 --process-id 0      # and --process-id 1 beside it

Counterpart of ``apps/train.py`` in the JAX package: builds the models and
the dataset from the YAML, loads the initial weights the config names
(the SD/ip2p UNet merged with the AnimateDiff motion weights, the VAE, the
text encoder) or runs on seeded random ones with
``--allow-random-weights``, then trains with gradient accumulation,
motion-only updates, a jsonl metric stream, checkpoints and resume. The
model computes in bf16 on the GPU (``--device cuda``, the default) and in
float32 on the CPU (``--device cpu``); ``--frozen-f32`` stores the models
in float32 on the GPU and computes in bf16 under autocast.

Several processes (``--coordinator`` with ``--num-processes`` and
``--process-id``, or ``--nnode > 1`` under torchrun's environment) train
data-parallel (``Trainer(group=)``): each rank draws ``accum * micro``
samples a step from its own stream (``draw_seed``), the optimizer
state is sharded over the ranks, and rank 0 alone logs, validates and
checkpoints. Batches are assembled ahead by a ``PrefetchLoader`` thread,
pinned, and copied to the GPU without blocking.

Each ``metrics.jsonl`` record of a step carries, beside ``step_time_s``,
the host milliseconds of its parts from the tracer's spans
(``utils/tracing.py``): ``forward_ms`` (the encodes and the UNet forward
of its microbatches), ``backward_ms``, ``update_ms`` (gradient
accumulation, all-reduce, optimizer and the copy into the model),
``loss_sync_ms`` (the wait for the loss, i.e. for the device),
``loader_wait_ms`` and ``loader_produce_ms`` (its batch's making in the
loader's thread), and the run's counts so far of the trainer's CUDA-graph
captures and replays (``graph_captures``, ``graph_replays``: spans
``train.graph_capture`` and ``train.graph_replay``; both 0 on the CPU).
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
    p.add_argument("--nnode", type=int, default=1,
                   help="multi-node: join the process group torchrun's environment "
                        "describes (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: the process group's address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--frozen-f32", action="store_true",
                   help="store the models in float32 on the GPU and compute under bf16 "
                        "autocast: more memory; matmuls and convolutions in bf16 as with "
                        "bf16-stored models, norms and biases in float32")
    return p


# a metrics.jsonl record's host ms of its step's parts: the tracer's spans
# of that step (``training/trainer.py``), summed over its microbatches
STEP_HOST_MS = {"forward_ms": ("train.encode", "train.forward"),
                "backward_ms": ("train.backward",),
                "update_ms": ("train.accumulate", "train.all_reduce", "train.optimizer",
                              "train.push_params"),
                "loss_sync_ms": ("train.loss_sync",)}


def step_host_ms(step: int) -> dict:
    """Host ms of ``step``'s parts (``STEP_HOST_MS``), of the loader's
    wait for the step's batch (``loader_wait_ms``) and of that batch's
    making in the loader's thread (``loader_produce_ms``)."""
    from insv2v_torch.utils import tracing

    out = {k: round(sum(tracing.unit_ms(n, step) for n in names), 3)
           for k, names in STEP_HOST_MS.items()}
    waits = tracing.records("loader.wait")
    if waits:
        wait = waits[-1]
        out["loader_wait_ms"] = round(wait.host_ms, 3)
        out["loader_produce_ms"] = round(tracing.unit_ms("loader.produce", wait.unit), 3)
    return out


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


def draw_seed(seed: int, rank: int, step: int) -> int:
    """The seed of a rank's data and noise streams from ``step`` on:
    ``seed + rank`` at step 0, as the JAX CLI seeds its loader with
    ``seed + process_index``; in a resumed run, one drawn from the three
    values jointly, so that no two (rank, step) pairs share a stream."""
    import numpy as np

    if step == 0:
        return seed + rank
    return int(np.random.SeedSequence([seed, rank, step]).generate_state(1)[0])


def _host_batch(batch, pin: bool):
    """A batch of numpy arrays as torch tensors, pinned for a copy to the
    GPU that does not block."""
    import torch

    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    from insv2v_torch._device import resolve_device
    from insv2v_torch.parallel.dist import Group, init_distributed, local_device

    dev = resolve_device(args.device)
    if args.coordinator or (args.num_processes or 0) > 1:
        init_distributed(args.coordinator, args.num_processes, args.process_id, device=dev)
    elif args.nnode > 1:
        init_distributed(device=dev)
    group = Group() if dist.is_initialized() else None
    try:
        _run(args, local_device(dev), group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _run(args, dev, group):
    import numpy as np
    import torch

    from insv2v_torch.data.datasets import dataset_from_config
    from insv2v_torch.data.native_loader import PrefetchLoader
    from insv2v_torch.parallel.dist import gather_optimizer_state, same_on_all_ranks
    from insv2v_torch.text.tokenizer import get_tokenizer
    from insv2v_torch.training.trainer import TrainConfig, Trainer
    from insv2v_torch.utils import tracing
    from insv2v_torch.utils.checkpoint import (load_into, load_pipeline_state_dicts,
                                               restore_train_state, save_train_state)
    from insv2v_torch.utils.config import load_config
    from insv2v_torch.utils.factory import build_models

    rank, world = (0, 1) if group is None else (group.rank, group.size)
    rank0 = rank == 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = load_config(args.config)
    tr = cfg["trainer"]
    expt_dir = os.path.join(cfg.get("expt_dir", "experiments"), cfg.get("expt_name", "run"))
    os.makedirs(expt_dir, exist_ok=True)
    if group is not None and rank0:
        print(f"data-parallel over {world} ranks; {group.describe()}")

    autocast = dev.type == "cuda" and args.frozen_f32
    dtype = torch.bfloat16 if dev.type == "cuda" and not autocast else torch.float32
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
    if group is not None and not same_on_all_ranks(
            [p for m in models.values() for p in m.parameters()], group):
        raise RuntimeError("the ranks start from different weights")

    tcfg = TrainConfig(
        lr=float(tr.get("lr", 1e-5)), loss_type=tr.get("loss_fn", "l2"),
        cond_image_dropout=float(tr.get("cond_image_dropout", 0.1)),
        scale_factor=float(tr.get("scale_factor", 0.18215)),
        accumulate_grad_batches=int(tr.get("accumulate_grad_batches", 1)),
        compute_dtype="bfloat16" if autocast else None,
        **{k: v for k, v in cfg.get("diffusion", {}).items()
           if k in ("beta_schedule", "num_train_timesteps", "beta_start", "beta_end")})
    trainer = Trainer(models["unet"], models["vae"], models["text_model"], tcfg, group=group)
    state = trainer.create_state()
    say = print if rank0 else (lambda *a, **k: None)
    if args.ckpt or args.resume:
        try:
            state = restore_train_state(args.ckpt or expt_dir, state)
            trainer.push_params(state)
            say(f"resumed at step {state.step}")
        except FileNotFoundError:
            if args.ckpt:
                raise
            say("no checkpoint found; starting fresh")

    micro = int(tr.get("micro_batch_size", 1))
    seed = draw_seed(args.seed, rank, state.step)
    batches = batch_iterator(dataset_from_config(cfg["data"]["train"]),
                             tcfg.accumulate_grad_batches * micro,
                             tr.get("prompt_type", "edit_prompt"), get_tokenizer(),
                             np.random.RandomState(seed))
    loader = PrefetchLoader(lambda: _host_batch(next(batches), dev.type == "cuda"), depth=2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_steps = args.max_steps or int(tr.get("max_steps", 1000))
    ckpt_every = int(tr.get("checkpoint_every", 1000))
    val_every = int(tr.get("val_every", 0))
    validate = None
    if val_every:
        from insv2v_torch.training.validation import make_validation_fn, save_preview_grid

        validate = make_validation_fn(
            trainer, num_steps=int(cfg.get("diffusion", {}).get("ddim_sampling_steps", 20)),
            text_cfg=float(tr.get("text_cfg", 7.5)), img_cfg=float(tr.get("img_cfg", 1.2)))

    logger = JsonlLogger(os.path.join(expt_dir, "metrics.jsonl")) if rank0 else None
    try:
        while state.step < max_steps:
            t0 = time.perf_counter()
            host = next(loader)
            batch = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            step = state.step
            state, metrics = trainer.train_step(state, batch, gen)
            dt = time.perf_counter() - t0
            if rank0:
                logger.log({"step": state.step, "train_loss": metrics["train_loss"],
                            "step_time_s": dt, **step_host_ms(step),
                            "graph_captures": tracing.count("train.graph_capture"),
                            "graph_replays": tracing.count("train.graph_replay")})
            say(f"step {state.step}: loss={metrics['train_loss']:.4f} ({dt:.1f}s)")
            if validate is not None and state.step % val_every == 0 and rank0:
                vb = {k: v[:micro].numpy() for k, v in host.items()}
                with trainer.compute():
                    out = validate(vb, gen)
                path = save_preview_grid(vb, out["pred"].float().cpu().numpy(),
                                         os.path.join(expt_dir, "previews"), state.step,
                                         trajectory=out["trajectory"].float().cpu().numpy())
                logger.log({"step": state.step, "preview": path})
            if state.step % ckpt_every == 0 or state.step >= max_steps:
                opt_state = None
                if group is not None:  # every rank sends its optimizer shard to rank 0
                    opt_state = gather_optimizer_state(state.optimizer, group, to=0)
                if rank0:
                    path = save_train_state(state, expt_dir, optimizer_state=opt_state)
                    print(f"checkpointed {path}")
        if group is not None:
            if not same_on_all_ranks(list(state.params.values()), group):
                raise RuntimeError(f"ranks disagree on the motion masters after step "
                                   f"{state.step}")
            say(f"motion masters equal on {world} ranks after step {state.step}")
    finally:
        loader.close()
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
