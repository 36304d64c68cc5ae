"""LOVEU-TGVE-2023 benchmark runner of the port: the CFG-grid product over
the videos and their four edit types, with skip-if-exists resume, GIF and
frame dumps, and the throughput of the run.

    python -m insv2v_torch.apps.run_loveu_tgve --ckpt insv2v.pth \\
        --data-dir loveu-tgve-2023 --text-cfg 7.5 10 --video-cfg 1.2 1.5

Counterpart of ``apps/run_loveu_tgve.py`` in the JAX package, with its
flags and outputs: ``{tag}.gif`` (input | edit) and ``{tag}/*.jpg`` per
edit, ``throughput.json`` (with the editor's seconds per stage summed
over the run under ``stage_seconds``, and the seconds spent writing the
GIFs and frames under ``output_seconds``), and ``prompts_used.json`` (one
``prompts_used.shardNN.json`` per shard) written atomically. The JAX
runner's executable-cache switches (``INSV2V_AOT_PIPELINE`` and the
compilation cache) have no counterpart here: the port compiles nothing
per shape, and its CUDA kernels are built once into the package's build
directory. ``--device`` picks the GPU (``cuda``, the default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from itertools import product

# the 76 x 4 edit instructions the reference ships with the benchmark
PACKAGED_PROMPT_DICT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "data", "loveu_tgve_edit_prompt_dict.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--text-cfg", nargs="+", type=float, default=[7.5])
    p.add_argument("--video-cfg", nargs="+", type=float, default=[1.8])
    p.add_argument("--num-frames", nargs="+", type=int, default=[32])
    p.add_argument("--image-size", nargs="+", type=int, default=[384])
    p.add_argument("--prompt-source", default="edit", choices=["edit", "original"],
                   help="'edit': per-video edit INSTRUCTIONS from the edit-prompt dict (the "
                   "reference's default and the paper's benchmark mode); 'original': the "
                   "CSV's edited-caption columns")
    p.add_argument("--edit-prompt-dict", default=None,
                   help="path to loveu_tgve_edit_prompt_dict.json (default: "
                   "<data-dir>/loveu_tgve_edit_prompt_dict.json, then the copy packaged "
                   "with insv2v_torch); only used with --prompt-source edit")
    p.add_argument("--ckpt-path", "--ckpt", dest="ckpt_path", default=None)
    p.add_argument("--config-path", default="configs/instruct_v2v.yaml")
    p.add_argument("--data-dir", default="loveu-tgve-2023")
    p.add_argument("--output-dir", default="loveu_outputs")
    p.add_argument("--with_optical_flow", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--scheduler", default="ddpm")
    p.add_argument("--frames-in-batch", type=int, default=16)
    p.add_argument("--num-ref-frames", type=int, default=4)
    p.add_argument("--noise-correct", type=float, default=0.5)
    p.add_argument("--limit-videos", type=int, default=None)
    p.add_argument("--allow-random-weights", action="store_true")
    p.add_argument("--num-shards", type=int, default=1,
                   help="split the sweep across N independent workers; combine with "
                   "--shard-index")
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--flow-estimator", default="auto",
                   choices=["auto", "farneback", "raft", "zero"])
    p.add_argument("--batch-edits", type=int, default=1,
                   help="how many of a video's edit prompts share one denoise chain (they "
                   "share the image conditioning); 1 runs the reference's serial order")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def load_edit_prompts(edit_prompt_dict, data_dir: str):
    """The edit-instruction dict: the explicit path, else a copy in the data
    directory, else the packaged copy; None (with a warning) if none exists."""
    candidates = [edit_prompt_dict] if edit_prompt_dict else [
        os.path.join(data_dir, "loveu_tgve_edit_prompt_dict.json"), PACKAGED_PROMPT_DICT]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        print(f"WARNING: --prompt-source edit but none of {candidates} exist — falling back "
              "to the CSV caption columns (--prompt-source original semantics)", flush=True)
        return None
    with open(path) as f:
        prompts = json.load(f)
    print(f"# edit prompts: {path}", flush=True)
    return prompts


def write_json_atomic(path: str, obj) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from insv2v_torch.apps.edit_video import make_editor
    from insv2v_torch.data.datasets import LoveuTgveVideoDataset
    from insv2v_torch.utils.media import concat_videos, save_frames, save_gif

    editor = make_editor(args.config_path, args.ckpt_path, args.scheduler, args.steps,
                         args.allow_random_weights, args.device)
    edit_prompts = (load_edit_prompts(args.edit_prompt_dict, args.data_dir)
                    if args.prompt_source == "edit" else None)

    def pick_prompt(video_name: str, prompt_key: str, item) -> str:
        if edit_prompts is None:
            return item[prompt_key]
        entry = edit_prompts.get(video_name)
        if entry is None or ("edit_" + prompt_key) not in entry:
            print(f"WARNING: no edit prompt for {video_name}/{prompt_key}; using the caption "
                  "column", flush=True)
            return item[prompt_key]
        return entry["edit_" + prompt_key]

    flow_est = None
    if args.with_optical_flow:
        from insv2v_torch.utils.flow import get_flow_estimator

        flow_est = get_flow_estimator(args.flow_estimator, device=editor.device)
    metrics = {"videos": 0, "frames": 0, "seconds": 0.0, "stage_seconds": {},
               "output_seconds": 0.0}
    prompts_used = {}  # tag -> the prompt the editor was given
    batch = max(1, args.batch_edits)
    for image_size in args.image_size:
        ds = LoveuTgveVideoDataset(args.data_dir, image_size=(image_size, image_size))
        names = ds.video_names()[: args.limit_videos] if args.limit_videos else ds.video_names()
        grid = list(product(names, args.text_cfg, args.video_cfg, args.num_frames))
        # static round-robin sharding: the grid's cells are independent
        grid = grid[args.shard_index:: args.num_shards]
        for video_name, text_cfg, video_cfg, num_frames in grid:
            item = ds[video_name]
            frames = item["frames"][::max(1, item["frames"].shape[0] // num_frames)][:num_frames]
            pending, tags = [], []
            for prompt_key in LoveuTgveVideoDataset.EDIT_KEYS:
                tag = (f"{video_name}-{prompt_key}-tcfg{text_cfg}-vcfg{video_cfg}-"
                       f"f{num_frames}-s{image_size}")
                if os.path.exists(os.path.join(args.output_dir, f"{tag}.gif")):
                    continue  # idempotent resume
                prompt = pick_prompt(video_name, prompt_key, item)
                pending.append(prompt)
                tags.append(tag)
                prompts_used[tag] = prompt
            # --batch-edits N > 1: N prompts share one denoise chain (a video
            # batch of N, 3N with the CFG triple); a partial resume batches
            # only the missing prompts
            for i in range(0, len(pending), batch):
                prompts = pending[i: i + batch]
                stages = {}
                t0 = time.perf_counter()
                edited_b = editor(frames, prompts, text_cfg=text_cfg, video_cfg=video_cfg,
                                  frames_per_window=args.frames_in_batch,
                                  num_ref_frames=args.num_ref_frames,
                                  noise_correct_step=args.noise_correct,
                                  use_motion_compensation=args.with_optical_flow,
                                  flow_estimator=flow_est, timings=stages)
                dt = time.perf_counter() - t0
                for k, v in stages.items():
                    metrics["stage_seconds"][k] = metrics["stage_seconds"].get(k, 0.0) + v
                t0 = time.perf_counter()
                for edited, tag in zip(edited_b, tags[i: i + len(prompts)]):
                    metrics["videos"] += 1
                    metrics["frames"] += int(edited.shape[0])
                    save_gif(concat_videos([frames, edited]),
                             os.path.join(args.output_dir, f"{tag}.gif"))
                    save_frames(edited, os.path.join(args.output_dir, tag))
                metrics["output_seconds"] += time.perf_counter() - t0
                metrics["seconds"] += dt
                nf = len(prompts) * frames.shape[0]
                print(f"{tags[i]} (+{len(prompts) - 1} batched): {dt:.1f}s "
                      f"({nf / dt:.2f} frames/s)", flush=True)

    if metrics["seconds"] > 0:
        metrics["frames_per_sec"] = metrics["frames"] / metrics["seconds"]
    os.makedirs(args.output_dir, exist_ok=True)
    write_json_atomic(os.path.join(args.output_dir, "throughput.json"), metrics)
    if prompts_used:
        # one file per shard, replaced atomically: shard workers share the
        # output directory, and a read-merge-write of one file would race
        fname = ("prompts_used.json" if args.num_shards == 1
                 else f"prompts_used.shard{args.shard_index:02d}.json")
        path = os.path.join(args.output_dir, fname)
        merged = {}
        if os.path.exists(path):  # this shard's earlier run
            with open(path) as f:
                merged = json.load(f)
        merged.update(prompts_used)
        write_json_atomic(path, merged)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
