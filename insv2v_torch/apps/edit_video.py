"""Single-video instruction editing CLI of the port:

    python -m insv2v_torch.apps.edit_video \\
        --video car-turn.mp4 --prompt "make it snowy" --output out.gif --ckpt insv2v.pth

Counterpart of ``apps/edit_video.py`` in the JAX package, with its flags
and defaults: 384 px, 32 frames sampled at 8 fps, 16-frame windows with 4
ref frames, DDPM 20 steps, text CFG 7.5 and video CFG 1.2, noise
correction over the first half of the steps, optical-flow motion
compensation with ``--with-optical-flow``. The output GIF shows the input
and the edit side by side. ``--config configs/insv2v_sdxl.yaml`` edits with
the SDXL-scale model (its two text towers, the added size embedding and
the VAE scale factor come from the config). The models run in bf16 on the
GPU (``--device cuda``, the default; it raises without one) or in float32
on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video", required=True, help="input video (mp4)")
    p.add_argument("--prompt", required=True, help="edit instruction")
    p.add_argument("--output", default="edited.gif")
    p.add_argument("--config", default="configs/instruct_v2v.yaml")
    p.add_argument("--ckpt", default=None, help="fused insv2v .pth checkpoint")
    p.add_argument("--image-size", type=int, default=384)
    p.add_argument("--num-frames", type=int, default=32)
    p.add_argument("--sampling-fps", type=int, default=8)
    p.add_argument("--text-cfg", type=float, default=7.5)
    p.add_argument("--video-cfg", type=float, default=1.2)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--scheduler", default="ddpm", choices=["ddpm", "ddim"])
    p.add_argument("--frames-in-batch", type=int, default=16)
    p.add_argument("--num-ref-frames", type=int, default=4)
    p.add_argument("--noise-correct", type=float, default=0.5)
    p.add_argument("--with-optical-flow", action="store_true")
    p.add_argument("--flow-estimator", default="auto",
                   choices=["auto", "farneback", "raft", "zero"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--allow-random-weights", action="store_true",
                   help="run without a checkpoint (smoke tests only)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def make_editor(config_path: str, ckpt, scheduler: str, steps: int, allow_random: bool,
                device=None, seed: int = 0):
    """The config's models with seeded random weights, overwritten by the
    fused checkpoint's pieces (the reference's ``strict=False``: pieces
    the checkpoint lacks stay random, with a warning), in a VideoEditor."""
    import torch

    from insv2v_torch._device import resolve_device
    from insv2v_torch.diffusion.pipeline import VideoEditor
    from insv2v_torch.models.vae import SD_SCALE_FACTOR
    from insv2v_torch.utils.checkpoint import load_into, load_pipeline_state_dicts
    from insv2v_torch.utils.config import load_config
    from insv2v_torch.utils.factory import build_models

    if not ckpt and not allow_random:
        sys.exit("no checkpoint given; pass --allow-random-weights to smoke-test without weights")
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    config = load_config(config_path)
    models = build_models(config, device=dev, dtype=dtype, seed=seed)
    sds = load_pipeline_state_dicts(fused_ckpt=ckpt) if ckpt else {}
    missing = {"unet", "vae", "text"} - set(sds)
    if missing and ckpt:
        print(f"WARNING: checkpoint lacks {sorted(missing)}; they stay random-init "
              "(strict=False semantics)", file=sys.stderr)
    load_into(models, sds)
    scale = (config.get("trainer") or {}).get("scale_factor", SD_SCALE_FACTOR)
    return VideoEditor(models["unet"], models["vae"], models["text_model"], scheduler=scheduler,
                       num_steps=steps, scale_factor=scale, device=dev, dtype=dtype)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from insv2v_torch.data.datasets import SingleVideoDataset
    from insv2v_torch.utils.media import concat_videos, save_gif

    frames = SingleVideoDataset(args.video, sampling_fps=args.sampling_fps,
                                num_frames=args.num_frames,
                                output_size=(args.image_size, args.image_size))[0]["frames"]
    editor = make_editor(args.config, args.ckpt, args.scheduler, args.steps,
                         args.allow_random_weights, args.device)
    flow_est = None
    if args.with_optical_flow:
        from insv2v_torch.utils.flow import get_flow_estimator

        flow_est = get_flow_estimator(args.flow_estimator, device=editor.device)
    edited = editor(frames, args.prompt, text_cfg=args.text_cfg, video_cfg=args.video_cfg,
                    frames_per_window=args.frames_in_batch, num_ref_frames=args.num_ref_frames,
                    noise_correct_step=args.noise_correct,
                    use_motion_compensation=args.with_optical_flow, flow_estimator=flow_est,
                    seed=args.seed)
    save_gif(concat_videos([frames, edited]), args.output)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
