"""Gradio web UI of the port for instruction video editing: upload an mp4,
type an edit instruction, tune the CFG levers, get the input and the edit
side by side.

    python -m insv2v_torch.apps.gradio_demo --ckpt insv2v.pth

Counterpart of ``apps/gradio_demo.py`` in the JAX package, with its flags,
preset examples and lazy editor (built on the first request), plus
``--device``: the editor runs in bf16 on the GPU (``cuda``, the default;
a request raises without one) or in float32 on the CPU (``--device cpu``).
``run_edit`` is the UI-free handler that ``apps/web_demo.py`` serves too.
gradio is imported only by ``main``, which exits with instructions where it
is not installed.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

EXAMPLES = [
    ["make it Van Gogh Starry Night style", 7.5, 1.2],
    ["make it a snowy scene", 7.5, 1.2],
    ["turn the video into a watercolor painting", 10.0, 1.5],
    ["make it autumn with falling leaves", 7.5, 1.2],
    ["turn day into night", 10.0, 1.2],
]

_EDITOR = None


def get_editor(args):
    """The one ``VideoEditor`` of the process, built on the first call."""
    global _EDITOR
    if _EDITOR is None:
        from insv2v_torch.apps.edit_video import make_editor

        _EDITOR = make_editor(args.config, args.ckpt, args.scheduler, args.steps,
                              args.allow_random_weights, args.device)
    return _EDITOR


def run_edit(args, video_path, prompt, text_cfg=7.5, video_cfg=1.2, noise_correct=0.5,
             motion_comp=True, seed=0, out_path=None):
    """The demo's edit handler, without a UI: edits ``args.num_frames``
    frames of the video, sampled at 8 fps and resized to
    ``args.image_size``, and returns the path of a GIF of the input and the
    edit side by side. Motion compensation takes ``get_flow_estimator
    ("auto")``: RAFT where ``$INSV2V_RAFT_WEIGHTS`` is set, else Farneback
    with a warning."""
    from insv2v_torch.data.datasets import SingleVideoDataset
    from insv2v_torch.utils.media import concat_videos, save_gif

    frames = SingleVideoDataset(video_path, sampling_fps=8, num_frames=args.num_frames,
                                output_size=(args.image_size, args.image_size))[0]["frames"]
    editor = get_editor(args)
    flow_est = None
    if motion_comp:
        from insv2v_torch.utils.flow import get_flow_estimator

        flow_est = get_flow_estimator("auto", device=editor.device)
    edited = editor(frames, prompt, text_cfg=text_cfg, video_cfg=video_cfg,
                    noise_correct_step=noise_correct, use_motion_compensation=motion_comp,
                    flow_estimator=flow_est, seed=int(seed))
    if out_path is None:
        out_path = tempfile.NamedTemporaryFile(suffix=".gif", delete=False).name
    save_gif(concat_videos([frames, edited]), out_path)
    return out_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/instruct_v2v.yaml")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--scheduler", default="ddpm")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--image-size", type=int, default=384)
    p.add_argument("--num-frames", type=int, default=32)
    p.add_argument("--share", action="store_true")
    p.add_argument("--allow-random-weights", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        import gradio as gr
    except ImportError:
        sys.exit("gradio is not installed; use `python -m insv2v_torch.apps.web_demo` for the "
                 "dependency-free web UI, or `python -m insv2v_torch.apps.edit_video` for the CLI")

    def edit(video_path, prompt, text_cfg, video_cfg, noise_correct, motion_comp, seed):
        return run_edit(args, video_path, prompt, text_cfg, video_cfg, noise_correct,
                        motion_comp, seed)

    demo = gr.Interface(
        fn=edit,
        inputs=[
            gr.Video(label="input video"),
            gr.Textbox(label="edit instruction"),
            gr.Slider(1.0, 15.0, value=7.5, label="text cfg"),
            gr.Slider(1.0, 3.0, value=1.2, label="video cfg"),
            gr.Slider(0.0, 1.0, value=0.5, label="noise correction"),
            gr.Checkbox(value=True, label="motion compensation"),
            gr.Number(value=0, label="seed"),
        ],
        outputs=gr.Image(label="original | edited"),
        title="InsV2V: instruction-driven video editing",
        examples=[[None] + e + [0.5, True, 0] for e in EXAMPLES],
    )
    demo.launch(share=args.share)


if __name__ == "__main__":
    main()
