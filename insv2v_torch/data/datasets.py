"""Datasets, host side in numpy (channels-last, [-1, 1]): the training
pairs, the LOVEU-TGVE benchmark videos and single videos to edit.

The port's own copy of ``data/datasets.py`` in the JAX package:

  * ``VideoPromptToPromptDataset`` and ``VideoPromptToPromptMotionAug``
    (the reference's dataset/videoP2P.py): folders of
    ``image/{seed}_{0|1}_{idx:04d}.jpg`` frames plus ``metadata.jsonl``
    (CLIP-score gates) and ``prompt.json``, a random window of
    ``num_frames``, and the camera-motion augmentation (linear
    translation-crop and zoom, the same for both videos);
  * ``LoveuTgveVideoDataset``: the LOVEU-TGVE-2023 CSV, whose section rows
    (``DAVIS Videos:``, ...) name each video's folder, with the original
    caption and four edited captions per video;
  * ``SingleVideoDataset``: one video resampled to ``sampling_fps``,
    resized to cover ``output_size`` and centre-cropped.

cv2 is imported only where images or videos are read or resized.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = ["VideoPromptToPromptDataset", "VideoPromptToPromptMotionAug",
           "LoveuTgveVideoDataset", "SingleVideoDataset", "CLIP_SCORE_GATES",
           "dataset_from_config"]

# metadata acceptance gates (videoP2P.py:35 / video_prompt_to_prompt.py:216)
CLIP_SCORE_GATES = dict(sim_0=0.2, sim_1=0.2, sim_dir=0.2, sim_image=0.5)


def _load_image(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def _passes_gates(meta: Dict) -> bool:
    return (
        meta.get("sim_dir", 0) > CLIP_SCORE_GATES["sim_dir"]
        and meta.get("sim_0", 0) > CLIP_SCORE_GATES["sim_0"]
        and meta.get("sim_1", 0) > CLIP_SCORE_GATES["sim_1"]
        and meta.get("sim_image", 0) > CLIP_SCORE_GATES["sim_image"]
    )


class VideoPromptToPromptDataset:
    """Folder scan: each sample dir holds image/ + metadata.jsonl +
    prompt.json; frames named ``{seed}_{0|1}_{idx:04d}.jpg`` over 16
    frames (videoP2P.py:14-23, 45-46)."""

    source_frames = 16

    def __init__(self, root_dirs, num_frames: int = 8,
                 rng: Optional[np.random.RandomState] = None):
        if isinstance(root_dirs, str):
            root_dirs = [root_dirs]
        self.num_frames = num_frames
        self.rng = rng or np.random.RandomState()
        self.image_folders: List[str] = []
        for root in root_dirs:
            if not os.path.isdir(root):
                continue
            for f in sorted(os.listdir(root)):
                d = os.path.join(root, f)
                if (
                    os.path.isdir(os.path.join(d, "image"))
                    and os.path.exists(os.path.join(d, "metadata.jsonl"))
                    and os.path.exists(os.path.join(d, "prompt.json"))
                ):
                    self.image_folders.append(d)

    def __len__(self) -> int:
        return len(self.image_folders)

    def _accepted_seeds(self, folder: str) -> List:
        seeds = []
        with open(os.path.join(folder, "metadata.jsonl")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                meta = json.loads(line)
                if _passes_gates(meta):
                    seeds.append(meta["seed"])
        return seeds

    def _load_pair(self, folder: str, seed, start: int) -> Tuple[np.ndarray, np.ndarray]:
        rng_idx = range(start, start + self.num_frames)
        inp = np.stack([
            _load_image(os.path.join(folder, "image", f"{seed}_0_{i:04d}.jpg"))
            for i in rng_idx
        ])
        out = np.stack([
            _load_image(os.path.join(folder, "image", f"{seed}_1_{i:04d}.jpg"))
            for i in rng_idx
        ])
        return inp, out

    def __getitem__(self, idx: int) -> Dict:
        folder = self.image_folders[idx]
        seeds = self._accepted_seeds(folder)
        seed = seeds[self.rng.randint(len(seeds))]
        with open(os.path.join(folder, "prompt.json")) as f:
            prompt = json.load(f)
        # Top-INCLUSIVE window draw — deliberate fix, not a parity slip: the
        # reference's top-exclusive `np.random.randint(0, 16 - num_frames)`
        # (videoP2P.py:42) crashes at num_frames=16 (high=0) and can never
        # pick the last valid start otherwise.
        start = self.rng.randint(0, self.source_frames - self.num_frames + 1)
        inp, out = self._load_pair(folder, seed, start)
        return {
            "input_video": inp * 2.0 - 1.0,
            "edited_video": out * 2.0 - 1.0,
            "input_prompt": prompt["input"],
            "output_prompt": prompt["output"],
            "edit_prompt": prompt["edit"],
        }


class VideoPromptToPromptMotionAug(VideoPromptToPromptDataset):
    """Adds camera-motion augmentation: linear translation-crop and
    zoom-in/out, applied identically to both videos (videoP2P.py:64-147)."""

    def __init__(self, *args, zoom_ratio=0.2, max_zoom=1.2,
                 translation_ratio=0.3, translation_range=(0, 0.2), **kwargs):
        super().__init__(*args, **kwargs)
        self.zoom_ratio = zoom_ratio
        self.max_zoom = max_zoom
        self.translation_ratio = translation_ratio
        self.translation_range = tuple(translation_range)

    def translation_crop(self, delta_h: float, delta_w: float,
                         images: np.ndarray) -> np.ndarray:
        import cv2

        H, W = images.shape[1:3]
        crop_h = int(H - abs(delta_h))
        crop_w = int(W - abs(delta_w))
        # the crop center travels linearly across the frames; a negative
        # delta reverses direction (videoP2P.py:85-105)
        if delta_h > 0:
            h_start = (H - delta_h) / 2
            h_end = h_start + delta_h
        else:
            h_end = H - (H + delta_h) / 2
            h_start = h_end + delta_h
        if delta_w > 0:
            w_start = (W - delta_w) / 2
            w_end = w_start + delta_w
        else:
            w_end = W - (W + delta_w) / 2
            w_start = w_end + delta_w
        cxs = np.linspace(w_start, w_end, self.num_frames)
        cys = np.linspace(h_start, h_end, self.num_frames)
        if delta_h < 0:
            cys = cys[::-1]
        if delta_w < 0:
            cxs = cxs[::-1]

        outs = []
        for img, cx, cy in zip(images, cxs, cys):
            x0 = int(cx - crop_w / 2)
            y0 = int(cy - crop_h / 2)
            crop = img[y0: y0 + crop_h, x0: x0 + crop_w]
            outs.append(cv2.resize(crop, (W, H), interpolation=cv2.INTER_CUBIC))
        return np.stack(outs)

    def zoom_aug(self, images: np.ndarray, final_scale: float,
                 direction: str) -> np.ndarray:
        import cv2

        if final_scale <= 1.02:
            return images
        H, W = images.shape[1:3]

        def zoom(img, scale):
            z = cv2.resize(img, (int(W * scale), int(H * scale)),
                           interpolation=cv2.INTER_CUBIC)
            y0 = (z.shape[0] - H) // 2
            x0 = (z.shape[1] - W) // 2
            return z[y0: y0 + H, x0: x0 + W]

        scales = np.linspace(1.0, final_scale, self.num_frames)
        if direction == "out":
            scales = scales[::-1]
        return np.stack([zoom(img, s) for img, s in zip(images, scales)])

    def motion_augmentation(self, inp: np.ndarray, out: np.ndarray):
        H, W = inp.shape[1:3]
        if self.rng.random_sample() < self.translation_ratio:
            dh = (self.rng.uniform(*self.translation_range) * H
                  * self.rng.choice([-1, 1]))
            dw = (self.rng.uniform(*self.translation_range) * W
                  * self.rng.choice([-1, 1]))
            inp = self.translation_crop(dh, dw, inp)
            out = self.translation_crop(dh, dw, out)
        if self.rng.random_sample() < self.zoom_ratio:
            scale = self.rng.uniform(1.0, self.max_zoom)
            direction = self.rng.choice(["in", "out"])
            inp = self.zoom_aug(inp, scale, direction)
            out = self.zoom_aug(out, scale, direction)
        return inp, out

    def __getitem__(self, idx: int) -> Dict:
        folder = self.image_folders[idx]
        seeds = self._accepted_seeds(folder)
        seed = seeds[self.rng.randint(len(seeds))]
        with open(os.path.join(folder, "prompt.json")) as f:
            prompt = json.load(f)
        # Top-inclusive draw: same deliberate fix as VideoPromptToPromptDataset
        # above (the reference's exclusive draw crashes at num_frames=16).
        start = self.rng.randint(0, self.source_frames - self.num_frames + 1)
        inp, out = self._load_pair(folder, seed, start)
        inp, out = self.motion_augmentation(inp, out)
        return {
            "input_video": inp * 2.0 - 1.0,
            "edited_video": out * 2.0 - 1.0,
            "input_prompt": prompt["input"],
            "output_prompt": prompt["output"],
            "edit_prompt": prompt["edit"],
        }


class LoveuTgveVideoDataset:
    """LOVEU-TGVE-2023: ``LOVEU-TGVE-2023_Dataset.csv`` under ``root_dir``
    (a header row, then sections headed ``DAVIS Videos:``, ``Videvo
    Videos:``, ``Youtube Videos:``) and the videos in
    ``{davis,videvo,youtube}_480p/480p_videos/{name}.mp4``. An item is the
    row's captions plus ``frames`` (every frame, resized to
    ``image_size`` = (H, W)) and ``fps``."""

    EDIT_KEYS = ("style", "object", "background", "multiple")

    def __init__(self, root_dir: str, image_size: Tuple[int, int] = (480, 480)):
        import csv

        self.root_dir = root_dir
        self.image_size = tuple(image_size)
        self.data: Dict[str, Dict] = {}
        source_folder = None
        with open(os.path.join(root_dir, "LOVEU-TGVE-2023_Dataset.csv")) as f:
            reader = csv.reader(f)
            next(reader, None)
            for row in reader:
                if not row or len(row[0]) == 0:
                    continue
                if row[0].endswith("Videos:"):
                    kind = row[0].split(" ")[0]
                    source_folder = ("DAVIS_480p/480p_videos" if kind == "DAVIS"
                                     else f"{kind.lower()}_480p/480p_videos")
                elif len(row) > 1:
                    self.data[row[0]] = {
                        "video_name": row[0], "original": row[1], "style": row[2],
                        "object": row[3], "background": row[4], "multiple": row[5],
                        "source_folder": source_folder}

    def __len__(self) -> int:
        return len(self.data)

    def video_names(self) -> List[str]:
        return list(self.data.keys())

    def __getitem__(self, idx) -> Dict:
        import cv2

        name = idx if isinstance(idx, str) else self.video_names()[idx]
        item = dict(self.data[name])
        cap = cv2.VideoCapture(os.path.join(self.root_dir, item["source_folder"],
                                            f"{name}.mp4"))
        frames = []
        try:
            while True:
                ok, fr = cap.read()
                if not ok:
                    break
                # cv2.resize takes (width, height); image_size is (H, W)
                fr = cv2.resize(fr, (self.image_size[1], self.image_size[0]))
                frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
            fps = cap.get(cv2.CAP_PROP_FPS)
        finally:
            cap.release()
        if not frames:
            raise ValueError(f"no frames decoded for {name}")
        item["frames"] = np.stack(frames).astype(np.float32) / 127.5 - 1.0
        item["fps"] = fps
        return item


class SingleVideoDataset:
    """Windows of one video, resampled to ``sampling_fps`` (a step of
    round(source fps / sampling_fps) frames), resized to cover
    ``output_size`` = (H, W) and centre-cropped; index k is the window
    starting at second k, padded by repeating its last frame."""

    def __init__(self, video_file: str, video_description: str = "", sampling_fps: int = 8,
                 num_frames: int = 16, output_size: Tuple[int, int] = (384, 384)):
        import cv2

        self.video_file = video_file
        self.video_description = video_description
        self.sampling_fps = sampling_fps
        self.num_frames = num_frames
        self.output_size = tuple(output_size)
        cap = cv2.VideoCapture(video_file)
        try:
            self.src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            self.total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()

    def __len__(self) -> int:
        return max(1, int(self.total_frames / self.src_fps))

    def __getitem__(self, start_second: int) -> Dict:
        import cv2

        from insv2v_torch.utils.media import resize_frame

        step = max(1, int(round(self.src_fps / self.sampling_fps)))
        start = int(start_second * self.src_fps)
        wanted = {start + i * step for i in range(self.num_frames)}
        last = max(wanted)
        cap = cv2.VideoCapture(self.video_file)
        frames, idx = [], 0
        try:
            while idx <= last:
                ok, fr = cap.read()
                if not ok:
                    break
                if idx in wanted:
                    fr = cv2.cvtColor(fr, cv2.COLOR_BGR2RGB)
                    frames.append(resize_frame(fr, *self.output_size))
                idx += 1
        finally:
            cap.release()
        if not frames:
            raise IndexError(f"no frames at second {start_second}")
        while len(frames) < self.num_frames:
            frames.append(frames[-1])
        arr = np.stack(frames).astype(np.float32) / 127.5 - 1.0
        return {"frames": arr, "text": self.video_description}


_DATASETS = {"VideoPromptToPrompt": VideoPromptToPromptDataset,
             "VideoPromptToPromptMotionAug": VideoPromptToPromptMotionAug}


def dataset_from_config(spec: Mapping[str, Any]):
    """A dataset from a config's ``{target, params}`` entry; the target's
    last dotted name picks the class (``dataset.videoP2P.VideoPromptToPrompt``
    in the reference's configs)."""
    name = spec["target"].rsplit(".", 1)[-1]
    if name not in _DATASETS:
        raise ValueError(f"dataset {spec['target']!r} is not ported; known: {sorted(_DATASETS)}")
    return _DATASETS[name](**dict(spec.get("params") or {}))
