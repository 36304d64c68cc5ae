"""Synthetic video prompt-to-prompt dataset generator, the port's: drives
the ModelScope T2V UNet with the three-phase prompt-to-prompt sampler,
decodes both videos, gates them on directional CLIP similarity, and
writes the VideoPromptToPrompt folder layout
(``image/{seed}_{0|1}_{frame:04d}.jpg`` + ``prompt.json`` +
``metadata.jsonl``) with a metadata-driven resume.

    python -m insv2v_torch.apps.generate_dataset --prompts prompts.json \\
        --output-dir video_ptp/raw_generated --num-samples 3 --device cuda

Counterpart of ``apps/generate_dataset.py`` in the JAX package, with its
flags and behaviour (the ``numpy.RandomState`` hyper draws, the phase
boundaries counted as the reference counts them, the records and their
``ptp_version``, the resume) plus ``--device``: the models run in bf16 on
the GPU (``cuda``, the default) and in float32 on the CPU (``cpu``).
Checkpoints load straight into the port's modules, which keep the
reference's keys: ``--unet-ckpt`` ModelScope's
``text2video_pytorch_model.pth``, ``--vae-ckpt`` its autoencoder,
``--clip-ckpt`` the open_clip ViT-H/14 model (its text tower is taken),
``--clip-filter-ckpt`` a HF ``CLIPModel`` (ViT-L/14).
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prompts", required=True,
                   help="json list of {input, output, edit} prompt triples")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--num-samples", type=int, default=3,
                   help="accepted samples to collect per prompt")
    p.add_argument("--max-attempts", type=int, default=10)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--latent-size", type=int, default=32)
    p.add_argument("--unet-ckpt", default=None, help="ModelScope text2video_pytorch_model.pth")
    p.add_argument("--vae-ckpt", default=None)
    p.add_argument("--clip-ckpt", default=None, help="OpenCLIP ViT-H text tower (conditioning)")
    p.add_argument("--clip-filter-ckpt", default=None,
                   help="HF CLIPModel (ViT-L/14) for the quality gate")
    p.add_argument("--allow-random-weights", action="store_true")
    p.add_argument("--no-clip-filter", action="store_true",
                   help="accept all samples (when no CLIP weights exist)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ptp-version", choices=("v1", "v2"), default="v2",
                   help="PTP sampler variant; the reference's data-gen uses v2 (attention-map "
                        "sharing); v1 is the staged copy-old variant "
                        "(inference_damo.py:52-157)")
    p.add_argument("--tiny", action="store_true",
                   help="fixture-sized models (CI smoke runs only)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def hyper_draws(rs):
    """One attempt's draws from the run's ``numpy.RandomState``, in the
    reference's order and on its grids (video_prompt_to_prompt.py:178-182):
    (seed, guidance, sa_end, ca_end, edit_weight)."""
    import numpy as np

    seed = int(rs.randint(0, 2 ** 31 - 1))
    guidance = float(rs.randint(5, 13))
    sa_end = round(float(rs.choice(np.linspace(0.3, 0.45, 4))), 2)
    ca_end = round(float(rs.choice(np.linspace(0.6, 0.85, 6))), 2)
    edit_weight = float(rs.randint(1, 6))
    return seed, guidance, sa_end, ca_end, edit_weight


def _load(module, sd, name):
    """Load ``sd`` over ``module``: every key the module has is required;
    keys it does not have (buffers, other towers) are ignored, as the JAX
    package's converters skip them."""
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise ValueError(f"{name} checkpoint lacks {len(missing)} keys: {missing[:5]}")


def build_models(args, dev, dtype):
    """{'unet', 'vae', 'text'}: the configs of ``--tiny`` or full width,
    made on ``dev`` (random from ``--seed``), loaded from the checkpoints
    given and cast to ``dtype``."""
    import torch

    from insv2v_torch.models.modelscope_t2v import ModelScopeConfig, UNetSD
    from insv2v_torch.models.openclip_text import (OpenClipTextConfig, OpenClipTextEncoder,
                                                   openclip_text_state_dict)
    from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
    from insv2v_torch.utils.checkpoint import load_torch_weights, strip_prefixes

    if args.tiny:
        ms_cfg = ModelScopeConfig.tiny(context_dim=16)
        vae_cfg = VaeConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4,
                            resolution=64)
        clip_cfg = OpenClipTextConfig(width=16, num_layers=2, num_heads=2)
    else:
        ms_cfg, vae_cfg, clip_cfg = ModelScopeConfig(), VaeConfig(), OpenClipTextConfig.vit_h_14()
    torch.manual_seed(args.seed)
    with torch.device(dev):
        models = {"unet": UNetSD(ms_cfg), "vae": AutoencoderKL(vae_cfg),
                  "text": OpenClipTextEncoder(clip_cfg)}
    ckpts = {"unet": args.unet_ckpt, "vae": args.vae_ckpt, "text": args.clip_ckpt}
    missing = sorted(k for k, v in ckpts.items() if not v)
    if missing and not args.allow_random_weights:
        raise SystemExit(f"missing weights for {missing}; pass --allow-random-weights for a "
                         f"smoke run")
    for name, path in ckpts.items():
        if path:
            sd = load_torch_weights(path)
            if name == "text":
                sd = openclip_text_state_dict(sd)
            elif name == "vae":
                sd = {k: v for k, v in strip_prefixes(sd).items() if not k.startswith("loss.")}
            _load(models[name], sd, name)
    return {k: m.to(dtype).eval() for k, m in models.items()}


def main(argv=None):
    """Returns {'records': [...], 'timings': [...]}: each attempt's
    metadata record and its stage seconds."""
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from insv2v_torch._device import resolve_device
    from insv2v_torch.data.datasets import CLIP_SCORE_GATES
    from insv2v_torch.diffusion.ptp_sampler import (frac_phase_steps, generator_noise,
                                                    sample_ptp_pair, sample_ptp_pair_v1)
    from insv2v_torch.diffusion.schedules import DiffusionSchedule, make_sampler_tables
    from insv2v_torch.models.vae import SD_SCALE_FACTOR
    from insv2v_torch.text.prompt_diff import build_ptp_key_value, compute_diff
    from insv2v_torch.text.tokenizer import get_tokenizer
    from insv2v_torch.utils.media import save_gif, to_uint8
    from insv2v_torch.utils.tracing import StageClock

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    with open(args.prompts) as f:
        prompts = json.load(f)[args.start: args.end]
    models = build_models(args, dev, dtype)
    unet, vae, text = models["unet"], models["vae"], models["text"]
    tokenizer = get_tokenizer()
    tables = make_sampler_tables(DiffusionSchedule.create(
        beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012), args.steps, "ddim")
    sample_fn = sample_ptp_pair if args.ptp_version == "v2" else sample_ptp_pair_v1

    @torch.no_grad()
    def encode_text(ids):
        return text(torch.as_tensor(np.asarray(ids), device=dev))

    clip_metric = None
    if args.clip_filter_ckpt:
        from insv2v_torch.utils.checkpoint import load_clip_model_state_dict
        from insv2v_torch.utils.clip_metrics import ClipSimilarity, clip_models

        clip_metric = ClipSimilarity(clip_models(state_dict=load_clip_model_state_dict(
            args.clip_filter_ckpt)), tokenizer=tokenizer, device=dev)
    elif not args.no_clip_filter:
        print("WARNING: no --clip-filter-ckpt given; accepting all samples "
              "(pass --no-clip-filter to silence)")

    rs = np.random.RandomState(args.seed)
    hw, records, timings = args.latent_size, [], []
    for p_idx, prompt in enumerate(prompts):
        out_dir = os.path.join(args.output_dir, f"sample_{p_idx + args.start:06d}")
        os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
        meta_path = os.path.join(out_dir, "metadata.jsonl")
        accepted = 0
        if os.path.exists(meta_path):  # resume (video_prompt_to_prompt.py:160-168)
            prior_versions = set()
            with open(meta_path) as f:
                for line in f:
                    m = json.loads(line)
                    accepted += bool(m.get("accepted"))
                    prior_versions.add(m.get("ptp_version", "unrecorded"))
            if prior_versions - {args.ptp_version}:
                print(f"WARNING: resuming {out_dir} with --ptp-version {args.ptp_version}, "
                      f"but existing records were generated with {sorted(prior_versions)} — "
                      "the sample set will mix PTP variants", flush=True)
        with open(os.path.join(out_dir, "prompt.json"), "w") as f:
            json.dump(prompt, f)

        attempts = 0
        while accepted < args.num_samples and attempts < args.max_attempts:
            attempts += 1
            seed, guidance, sa_end, ca_end, edit_weight = hyper_draws(rs)
            stages = {}
            with StageClock(dev, stages) as clock:
                pieces = compute_diff(prompt["input"], prompt["output"])
                for piece in pieces:
                    if piece.old != piece.new:
                        piece.weight = edit_weight
                ctx_old = encode_text(tokenizer([prompt["input"]]))
                ctx_new = encode_text(tokenizer([prompt["output"]]))
                ctx_un = encode_text(tokenizer([""]))
                key_ctx, val_ctx = build_ptp_key_value(
                    pieces, tokenizer, lambda ids: encode_text(ids).float().cpu().numpy())
                kv = (torch.as_tensor(key_ctx, device=dev), torch.as_tensor(val_ctx, device=dev))
                clock.mark("text")

                gen = torch.Generator(device=dev).manual_seed(seed)
                lat = torch.randn((1, args.num_frames, hw, hw, 4), generator=gen, device=dev)
                # the reference's boundaries (`i < frac * steps`); at a few steps
                # the two grids can meet, so phase 2 keeps at least one step
                sa_steps = frac_phase_steps(sa_end, args.steps)
                ca_steps = min(max(frac_phase_steps(ca_end, args.steps), sa_steps + 1),
                               args.steps)
                with torch.no_grad():
                    out = sample_fn(lambda x, t, c, share: unet(x, t, c, sa_share=share),
                                    tables, lat, ctx_new, ctx_old, kv, ctx_un,
                                    guidance_scale=guidance, sa_steps=sa_steps,
                                    ca_steps=ca_steps, noise=generator_noise(gen),
                                    timings=stages)
                    clock.mark("sample")
                    frames = {tag: vae.decode(z[0] / SD_SCALE_FACTOR).float().clamp(-1, 1)
                              .cpu().numpy() for tag, z in (("0", out["latent_old"]),
                                                            ("1", out["latent"]))}
                clock.mark("decode")

                if clip_metric is not None:
                    s = clip_metric(frames["0"], frames["1"], [prompt["input"]],
                                    [prompt["output"]])
                    scores = dict(sim_0=float(np.mean(s["sim_0"])),
                                  sim_1=float(np.mean(s["sim_1"])),
                                  sim_dir=float(np.mean(s["sim_direction"])),
                                  sim_image=float(np.mean(s["sim_image"])))
                    ok = all(scores[k] > CLIP_SCORE_GATES[k]
                             for k in ("sim_0", "sim_1", "sim_dir", "sim_image"))
                else:
                    scores = dict(sim_0=1.0, sim_1=1.0, sim_dir=1.0, sim_image=1.0)
                    ok = True
                clock.mark("score")
                record = dict(seed=seed, guidance=guidance, sa_end=sa_end, ca_end=ca_end,
                              edit_weight=edit_weight, ptp_version=args.ptp_version,
                              accepted=ok, **scores)
                with open(meta_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
                if ok:
                    import cv2

                    for tag in ("0", "1"):
                        for i, fr in enumerate(to_uint8(frames[tag])):
                            cv2.imwrite(os.path.join(out_dir, "image",
                                                     f"{seed}_{tag}_{i:04d}.jpg"),
                                        cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
                    save_gif(frames["1"], os.path.join(out_dir, f"{seed}.gif"))
                    accepted += 1
                clock.mark("write")
            stages.update(pair=clock.total, sa_steps=sa_steps, ca_steps=ca_steps)
            records.append(record)
            timings.append(stages)
            print(f"attempt {attempts} seed {seed}: {'accepted' if ok else 'rejected'}; "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()
                              if isinstance(v, float)), flush=True)
        print(f"prompt {p_idx}: accepted {accepted} in {attempts} attempts")
    return {"records": records, "timings": timings}


if __name__ == "__main__":
    main()
