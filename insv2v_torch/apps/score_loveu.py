"""Directional-CLIP scoring of LOVEU-TGVE outputs, the port's scorer: for
each GIF ``run_loveu_tgve`` wrote, sim_0 / sim_1 / sim_direction /
sim_image of its input (left half) and edit (right half) against the
original and the edited caption, averaged over sampled frames, into
``clip_scores.json`` beside the GIFs.

    python -m insv2v_torch.apps.score_loveu --outputs loveu_outputs \\
        --data-dir loveu-tgve-2023 --clip-ckpt clip_model.bin

Counterpart of ``apps/score_loveu.py`` in the JAX package, with its flags;
``--clip-ckpt`` is a HF ``CLIPModel`` (ViT-L/14) state dict, loaded
directly (the port keeps HF's keys). The towers run in float32 on the GPU
(``--device cuda``, the default) or the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import re

TAG_RE = re.compile(r"^(?P<video>.+?)-(?P<edit>style|object|background|multiple)-")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--outputs", required=True, help="directory of {video}-{edit}-...gif files")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--clip-ckpt", default=None, help="HF CLIPModel state dict (ViT-L/14)")
    p.add_argument("--frames-per-video", type=int, default=8,
                   help="frames sampled per video for scoring")
    p.add_argument("--allow-random-weights", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from insv2v_torch.data.datasets import LoveuTgveVideoDataset
    from insv2v_torch.utils.clip_metrics import ClipSimilarity, clip_models
    from insv2v_torch.utils.media import load_gif

    if args.clip_ckpt:
        from insv2v_torch.utils.checkpoint import load_clip_model_state_dict

        models = clip_models(state_dict=load_clip_model_state_dict(args.clip_ckpt))
    elif args.allow_random_weights:
        models = clip_models()
    else:
        raise SystemExit("need --clip-ckpt (or --allow-random-weights to smoke)")
    sim = ClipSimilarity(models, device=args.device)

    ds = LoveuTgveVideoDataset(args.data_dir)
    records = []
    for fname in sorted(os.listdir(args.outputs)):
        m = TAG_RE.match(fname)
        if not fname.endswith(".gif") or not m or m.group("video") not in ds.data:
            continue
        item = ds.data[m.group("video")]
        gif = load_gif(os.path.join(args.outputs, fname))
        w = gif.shape[2] // 2  # the runner saves input | edit side by side
        step = max(1, gif.shape[0] // args.frames_per_video)
        orig, edited = gif[::step, :, :w], gif[::step, :, w:]
        scores = sim(orig, edited, [item["original"]], [item[m.group("edit")]])
        records.append({"file": fname, "video": m.group("video"), "edit": m.group("edit"),
                        **{k: float(np.mean(v)) for k, v in scores.items()}})
    summary = {"count": len(records),
               **{k: float(np.mean([r[k] for r in records])) if records else 0.0
                  for k in ("sim_0", "sim_1", "sim_direction", "sim_image")},
               "records": records}
    with open(os.path.join(args.outputs, "clip_scores.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "records"}))
    return summary


if __name__ == "__main__":
    main()
