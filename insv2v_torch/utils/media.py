"""Image and video I/O on the host: numpy, channels-last, float in [-1, 1]
unless noted.

The port's own copy of ``utils/media.py`` in the JAX package, for the
edit CLI and the LOVEU runner and scorer: uint8 conversion, GIF save and
load, frame dumps, mp4 decoding with an aspect-preserving resize and
centre crop, side-by-side concatenation, and the reference's
``image_utils.py`` extras: canny edges, histogram matching and caption
overlays.

GIFs go through Pillow: it is installed wherever the port runs, GPU
machine included, while imageio (the JAX package's GIF library, itself a
wrapper over Pillow for this format) is not. Videos and JPEG frames go
through OpenCV, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["to_uint8", "from_uint8", "save_gif", "load_gif", "save_frames", "resize_frame",
           "read_video_frames", "concat_videos", "canny_edges", "match_histogram", "overlay_text"]


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return (np.clip(frames, -1.0, 1.0) * 127.5 + 127.5).round().astype(np.uint8)


def from_uint8(frames: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]."""
    return frames.astype(np.float32) / 127.5 - 1.0


def save_gif(frames: np.ndarray, path: str, fps: int = 8) -> None:
    """frames (F, H, W, 3) in [-1, 1] -> an animated GIF that loops."""
    from PIL import Image

    from insv2v_torch.utils.tracing import span

    with span("media.save_gif"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        images = [Image.fromarray(f) for f in to_uint8(frames)]
        images[0].save(path, save_all=True, append_images=images[1:], duration=1000.0 / fps,
                       loop=0)


def load_gif(path: str) -> np.ndarray:
    """An animated GIF -> frames (F, H, W, 3) in [-1, 1]."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
    return from_uint8(np.stack(frames))


def save_frames(frames: np.ndarray, out_dir: str, prefix: str = "") -> List[str]:
    """Dump frames as ``{prefix}{i:05d}.jpg`` under ``out_dir`` (the LOVEU
    runner's output layout); returns the paths."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, fr in enumerate(to_uint8(frames)):
        p = os.path.join(out_dir, f"{prefix}{i:05d}.jpg")
        cv2.imwrite(p, cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
        paths.append(p)
    return paths


def resize_frame(frame: np.ndarray, height: int, width: int,
                 keep_aspect: bool = True) -> np.ndarray:
    """Resize a uint8 frame (H, W, 3) to (height, width): scaled to cover
    and centre-cropped when ``keep_aspect``, else stretched (area filter)."""
    import cv2

    h, w = frame.shape[:2]
    if keep_aspect:
        scale = max(height / h, width / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        frame = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)
        top, left = (nh - height) // 2, (nw - width) // 2
        return frame[top: top + height, left: left + width]
    return cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)


def read_video_frames(path: str, num_frames: Optional[int] = None, start_frame: int = 0,
                      frame_skip: int = 1, height: Optional[int] = None,
                      width: Optional[int] = None) -> np.ndarray:
    """Decode a video into (F, H, W, 3) in [-1, 1]: every ``frame_skip``-th
    frame from ``start_frame``, at most ``num_frames``, resized when
    ``height`` and ``width`` are given."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames, idx = [], 0
    try:
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            if idx >= start_frame and (idx - start_frame) % frame_skip == 0:
                fr = cv2.cvtColor(fr, cv2.COLOR_BGR2RGB)
                if height is not None and width is not None:
                    fr = resize_frame(fr, height, width)
                frames.append(fr)
                if num_frames is not None and len(frames) >= num_frames:
                    break
            idx += 1
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return from_uint8(np.stack(frames))


def concat_videos(videos: Sequence[np.ndarray], axis: int = 2) -> np.ndarray:
    """Side-by-side (``axis=2``: width) concatenation of equal-length videos."""
    return np.concatenate(list(videos), axis=axis)


def canny_edges(frames: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Canny edge maps of a batch: (F, H, W, 3) in [-1, 1] -> (F, H, W, 1)
    in [-1, 1]."""
    import cv2

    edges = [cv2.Canny(cv2.cvtColor(fr, cv2.COLOR_RGB2GRAY), low, high)
             for fr in to_uint8(frames)]
    return from_uint8(np.stack(edges)[..., None])


def match_histogram(source: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching of ``source`` to ``reference``, both
    (H, W, 3) in [-1, 1]."""
    src, ref = to_uint8(source), to_uint8(reference)
    out = np.empty_like(src)
    for c in range(src.shape[-1]):
        s_vals, s_idx, s_counts = np.unique(src[..., c].ravel(), return_inverse=True,
                                            return_counts=True)
        r_vals, r_counts = np.unique(ref[..., c].ravel(), return_counts=True)
        s_q = np.cumsum(s_counts).astype(np.float64)
        s_q /= s_q[-1]
        r_q = np.cumsum(r_counts).astype(np.float64)
        r_q /= r_q[-1]
        out[..., c] = np.interp(s_q, r_q, r_vals)[s_idx].reshape(src[..., c].shape)
    return from_uint8(out)


def overlay_text(frame: np.ndarray, text: str, scale: float = 0.5) -> np.ndarray:
    """A caption burnt into the bottom left of a frame (H, W, 3) in [-1, 1]."""
    import cv2

    img = to_uint8(frame).copy()
    cv2.putText(img, text, (4, img.shape[0] - 8), cv2.FONT_HERSHEY_SIMPLEX, scale,
                (255, 255, 255), 1, cv2.LINE_AA)
    return from_uint8(img)
