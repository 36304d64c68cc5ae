"""The training driver: motion-module optimizer steps back to back
through the port's ``Trainer.train_step``, fed as ``apps/train.py``
feeds it.

Set-up writes a synthetic prompt-to-prompt dataset from the seed under
``TMPDIR`` (each sample folder a pair of 16-frame videos as JPEGs, its
captions and one accepted record), opens it with the port's dataset of
the configuration (``VideoPromptToPromptMotionAug``), draws batches as
the train CLI does (``batch_iterator``, copied here) through the port's
``PrefetchLoader``, builds the trainer and its optimizer state, and runs
the first ``checked_steps`` steps through the same call and feed as the
window; the window goes on with that same trainer and state. Every
microbatch's draws (the two posterior normals, the cond drop, eps and t)
come from the seed through ``draws``. ``check`` has the float32
reference (``reference/train.py``) rebuild the checked steps' batches
from the files and follow the same steps.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from counters import launch_counters
from harness import Readings, derive_seed, load_weights, log, seeded_weights
from reference import insv2v as ref_v2v
from reference import train as ref
from reference.ops import precision, rel, strict_fp32
from work.kernels import unet3d_launches

MOTION = "motion_modules."
# the first elements of each motion leaf's first gradient, kept for the
# comparison of its direction
SAMPLE = 1024
# the traced run's stretch: one whole optimizer step, then HOST_MICRO
# microbatches of the next one with the host's ops traced
HOST_MICRO = 2


class _StopStep(Exception):
    """Ends the profiled steps once the stretch is over."""


def batch_iterator(dataset, batch_size: int, prompt_type: str, tokenizer, rng):
    """Random samples stacked into batches of numpy arrays (the train CLI's
    draw, ``apps/train.py``)."""
    while True:
        items = [dataset[int(i)] for i in rng.randint(0, len(dataset), size=batch_size)]
        yield {
            "input_video": np.stack([it["input_video"] for it in items]).astype(np.float32),
            "edited_video": np.stack([it["edited_video"] for it in items]).astype(np.float32),
            "prompt_ids": np.asarray(tokenizer([it[prompt_type] for it in items])),
        }


def write_dataset(root: str, seed: int, samples: int, frames: int, size: int) -> None:
    """``samples`` folders of a prompt-to-prompt dataset from ``seed``: two
    16-frame videos of a smooth moving pattern (the second with another
    phase and tint), JPEG as the generator writes them, the captions and
    one accepted record."""
    import cv2

    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij")
    tt = np.arange(frames)[:, None, None, None] * 0.1
    for j in range(samples):
        rs = np.random.RandomState(derive_seed(seed, "sample", j) % 2 ** 32)
        folder = os.path.join(root, f"sample_{j:06d}")
        os.makedirs(os.path.join(folder, "image"))
        phase, tint = rs.uniform(0, 6.28, (2, 3)), rs.uniform(0.5, 1.0, 3)
        s = int(rs.randint(0, 2 ** 31 - 1))
        for tag in (0, 1):
            vid = np.sin(3 * xx[None, ..., None] + 2 * yy[None, ..., None] + tt + phase[tag])
            vid = ((0.5 + 0.45 * vid * (tint if tag else 1.0)) * 255).astype(np.uint8)
            for i, fr in enumerate(vid):
                cv2.imwrite(os.path.join(folder, "image", f"{s}_{tag}_{i:04d}.jpg"),
                            cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
        with open(os.path.join(folder, "prompt.json"), "w") as f:
            json.dump({"input": f"a pattern {j}", "output": f"a tinted pattern {j}",
                       "edit": f"tint the pattern {j}"}, f)
        with open(os.path.join(folder, "metadata.jsonl"), "w") as f:
            f.write(json.dumps({"seed": s, "sim_0": 0.3, "sim_1": 0.3, "sim_dir": 0.3,
                                "sim_image": 0.8, "accepted": True}) + "\n")


class Driver:
    unit = "step"

    def __init__(self, cell, seed: int, device="cuda", trace: bool = False):
        self.cell, self.seed, self.trace = cell, int(seed), trace
        self.device = torch.device(device)
        self.t, self.cfg = cell.traffic, cell.config
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.root = tempfile.mkdtemp(prefix="bench_train_")
        self.spans: Dict[str, float] = {"wait": 0.0, "step": 0.0}
        self.steps_done = 0
        self.losses: List[float] = []
        self.batches: List[Dict] = []
        self.loader = None

    # --- set-up --------------------------------------------------------------

    def setup(self):
        from insv2v_torch.data.datasets import VideoPromptToPromptMotionAug
        from insv2v_torch.data.native_loader import PrefetchLoader
        from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
        from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
        from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
        from insv2v_torch.ops import attention
        from insv2v_torch.text.tokenizer import HashTokenizer
        from insv2v_torch.training.trainer import TrainConfig, Trainer

        t, c = self.t, self.cfg
        tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        t0 = time.perf_counter()
        with torch.device("meta"):
            models = {"unet": UNet3DConditionModel(UNetConfig(**tup(c["unet"]), remat=t["remat"])),
                      "vae": AutoencoderKL(VaeConfig(**tup(c["vae"]))),
                      "text": ClipTextEncoder(ClipTextConfig(**c["text"]))}
        self.weights = {n: seeded_weights(m, derive_seed(self.seed, n), self.device, self.dtype)
                        for n, m in models.items()}
        # the trainer writes its steps into the UNet's motion tensors, which
        # are the benchmark's: keep their first values for the reference
        self.motion_init = {k: v.clone() for k, v in self.weights["unet"].items() if MOTION in k}
        for n, m in models.items():
            load_weights(m, self.weights[n])
        attention.FLASH_HEADFOLD = t["headfold"]  # kernel A' on, as training runs it
        write_dataset(self.root, self.seed, t["samples"], t["frames"], t["size"])
        aug = t["augmentation"]
        dataset = VideoPromptToPromptMotionAug(
            self.root, num_frames=t["frames"],
            rng=np.random.RandomState(derive_seed(self.seed, "dataset") % 2 ** 32), **aug)
        batch_rows = t["accumulate"] * t["micro_batch"]
        batches = batch_iterator(dataset, batch_rows, t["prompt_type"], HashTokenizer(),
                                 np.random.RandomState(derive_seed(self.seed, "batches") % 2 ** 32))
        pin = self.device.type == "cuda"

        def host_batch():
            out = {k: torch.from_numpy(v) for k, v in next(batches).items()}
            return {k: v.pin_memory() for k, v in out.items()} if pin else out

        self.loader = PrefetchLoader(host_batch, depth=2)
        self.tcfg = TrainConfig(lr=t["lr"], betas=tuple(t["betas"]), optimizer=t["optimizer"],
                                loss_type=t["loss"], prediction_type=t["prediction"],
                                cond_image_dropout=t["cond_image_dropout"],
                                scale_factor=c["scale_factor"],
                                accumulate_grad_batches=t["accumulate"],
                                **{k: c["diffusion"][k] for k in ("beta_schedule",
                                   "num_train_timesteps", "beta_start", "beta_end")})
        self.models = models
        self.trainer = Trainer(models["unet"], models["vae"], models["text"], self.tcfg)
        self.state = self.trainer.create_state()
        log(f"weights, dataset ({t['samples']} pairs), trainer: {time.perf_counter() - t0:.2f} s")
        # the checked steps: the window's own call and feed, recorded
        t0 = time.perf_counter()
        masters = self.state.params
        for k in range(t["checked_steps"]):
            host = self._step(record=True)
            self.batches.append(host)
            if k == 0:  # Adam's first moment after one step is (1 - b1) g
                opt = self.state.optimizer.state
                g1 = {n: opt[p]["exp_avg"] / (1 - t["betas"][0]) if "exp_avg" in opt.get(p, {})
                      else torch.zeros_like(p) for n, p in masters.items()}
                self.grad1 = {n: float(g.norm()) for n, g in g1.items()}
                self.grad_sample = torch.cat([g.flatten()[:SAMPLE] for g in g1.values()])
        self.change = {n: float((p - self.motion_init[n].float()).norm())
                       for n, p in masters.items()}
        self.draw_log = self._draws_for(range(t["checked_steps"]))
        log(f"checked steps: {t['checked_steps']} in {time.perf_counter() - t0:.2f} s, "
            f"losses {self.losses}")

    def _draws(self, step: int) -> List[Dict[str, torch.Tensor]]:
        """The microbatches' draws of a step, from the seed."""
        t, dev = self.t, self.device
        b, f, h = t["micro_batch"], t["frames"], t["size"] // 8
        gen = torch.Generator(device=dev)
        gen.manual_seed(derive_seed(self.seed, "draws", step))
        out = []
        for _ in range(t["accumulate"]):
            n = lambda *s: torch.randn(s, generator=gen, device=dev)
            out.append({"enc_cond": n(b * f, h, h, 4), "enc_edit": n(b * f, h, h, 4),
                        "drop": torch.rand(b, generator=gen, device=dev) < t["cond_image_dropout"],
                        "eps": n(b, f, h, h, 4),
                        "t": torch.randint(0, 1000, (b,), generator=gen, device=dev)})
        return out

    def _draws_for(self, steps) -> List[List[Dict[str, torch.Tensor]]]:
        return [self._draws(k) for k in steps]

    def _step(self, record: bool = False):
        """One optimizer step: the next batch from the loader (the wait is
        the driver's span), to the device, ``train_step``."""
        t0 = time.perf_counter()
        host = next(self.loader)
        t1 = time.perf_counter()
        batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        self.state, m = self.trainer.train_step(self.state, batch,
                                                draws=self._draws(self.steps_done))
        self.losses.append(m["train_loss"])  # a float: the step has ended
        self.spans["wait"] += t1 - t0
        self.spans["step"] += time.perf_counter() - t0
        self.steps_done += 1
        return {k: v.numpy().copy() for k, v in host.items()} if record else None

    # --- units -----------------------------------------------------------------

    def run_unit(self, k: int) -> int:
        if k == 0:
            self.spans = {"wait": 0.0, "step": 0.0}
            self.window_from = self.steps_done
        self._step()
        t = self.t
        return t["accumulate"] * t["micro_batch"] * t["frames"]

    def end_to_end(self, units: int, wall: float) -> Dict[str, float]:
        t = self.t
        return {"train_frames_per_s": units * t["accumulate"] * t["micro_batch"] * t["frames"] / wall}

    def describe(self, units: int, wall: float) -> List[str]:
        return [f"steps {units} in {wall:.3f} s: {wall / units:.3f} s a step, "
                f"{wall / units / self.t['accumulate']:.4f} s a microbatch; loader wait "
                f"{self.spans['wait']:.3f} s; losses {self.losses[self.window_from:]}"]

    # --- the traced run --------------------------------------------------------

    def readings(self, r: Readings, units: int, wall: float):
        from harness import Stretch

        t = self.t
        r.spans = dict(self.spans)
        r.counts = {"steps": units, "microbatches": units * t["accumulate"]}
        r.unit_wall_ms = 1e3 * self.spans["step"] / units
        r.flops_per_unit = self.flops_per_step()
        stretch = Stretch(launch_counters, t["accumulate"], HOST_MICRO)
        real = self.trainer.microbatch_loss
        calls = [0]

        def marked(*a, **k):
            if stretch.mark(calls[0]):
                raise _StopStep
            calls[0] += 1
            return real(*a, **k)

        self.trainer.microbatch_loss = marked
        try:
            while True:
                self._step()
        except _StopStep:
            pass
        finally:
            self.trainer.microbatch_loss = real
        stretch.fill(r)
        r.stretch_calls = 1
        per_micro = unet3d_launches(self.cfg["unet"], t["micro_batch"], t["frames"],
                                    t["size"] // 8, t["size"] // 8)
        # remat reruns each block's forward, kernel B's launch with it
        r.work = {"ff": per_micro["ff"] * 2 * t["accumulate"]}
        log(f"profiled stretch: one step ({t['accumulate']} microbatches), "
            f"{len(r.trace.device_ops)} device ops, launches {r.launches}")

    def flops_per_step(self) -> float:
        """Model FLOPs of a step, counted over the reference on the meta
        device: for each microbatch the text encode, the VAE encodes of both
        videos, the UNet forward and its backward to the motion modules
        (remat's rerun left out)."""
        from torch.utils.flop_counter import FlopCounterMode

        t, c = self.t, self.cfg
        meta = {n: {k: torch.empty(v.shape, device="meta") for k, v in w.items()}
                for n, w in self.weights.items()}
        motion = {k: torch.empty(v.shape, device="meta", requires_grad=True)
                  for k, v in self.motion_init.items()}
        meta["unet"].update(motion)
        b, f, s = t["micro_batch"], t["frames"], t["size"]
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        counter = FlopCounterMode(display=False)
        with counter:
            with torch.no_grad():
                ref_v2v.clip_text(meta["text"], torch.zeros((b, 77), dtype=torch.long, device="meta"),
                                  c["text"]["num_layers"], c["text"]["num_heads"])
                ref_v2v.vae_moments(meta["vae"], torch.empty((2 * b * f, s, s, 3), device="meta"),
                                    vl, vb)
            x = torch.empty((b, f, s // 8, s // 8, 8), device="meta")
            pred = ref_v2v.unet3d(meta["unet"], c["unet"], x,
                                  torch.zeros(b, dtype=torch.long, device="meta"),
                                  torch.empty((b, 77, c["unet"]["cross_attention_dim"]),
                                              device="meta"), 0)
            torch.autograd.grad(pred.float().square().mean(), list(motion.values()))
        return float(counter.get_total_flops() * t["accumulate"])

    # --- the check ---------------------------------------------------------------

    def release(self):
        if self.loader is not None:
            self.loader.close()
        for name in ("trainer", "state", "models"):
            if hasattr(self, name):
                delattr(self, name)
        shutil.rmtree(self.root, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, batches):
        t = self.t
        tcfg = {"betas": tuple(t["betas"]), "lr": t["lr"], "accumulate": t["accumulate"]}
        return ref.train_steps(self.weights, self.cfg, tcfg, batches, self.draw_log,
                               self.motion_init, t["checked_steps"])

    def check(self, control: bool = False):
        """{name: number} for the program and, with ``control``, for the
        reference one precision lower (fp8) in the program's place: the
        checked steps' batches against the reference's rebuild (exact), the
        largest gap of a step's loss, by the worst leaf the gap of the first
        gradient's norm and of the motion parameters' change, and the first
        gradient's direction over each leaf's first elements."""
        strict_fp32()
        t = self.t
        data_root = tempfile.mkdtemp(prefix="bench_train_ref_")
        try:
            write_dataset(data_root, self.seed, t["samples"], t["frames"], t["size"])
            ds = ref.PairDataset(data_root, t["frames"],
                                 np.random.RandomState(derive_seed(self.seed, "dataset") % 2 ** 32),
                                 **t["augmentation"])
            rebuilt = ref.batches(ds, t["accumulate"] * t["micro_batch"], t["prompt_type"],
                                  np.random.RandomState(derive_seed(self.seed, "batches") % 2 ** 32),
                                  t["checked_steps"])
        finally:
            shutil.rmtree(data_root, ignore_errors=True)
        data = max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                   for a, b in zip(self.batches, rebuilt) for k in a)
        out = self._reference(rebuilt)
        numbers = lambda run: self._numbers(run, out)
        prog = {"data": data, **self._numbers({"losses": self.losses[:t["checked_steps"]],
                                               "grad": self.grad1, "change": self.change,
                                               "sample": self.grad_sample}, out)}
        ctrl = {}
        if control:
            with precision("fp8"):
                low = self._reference(rebuilt)
            ctrl = {"data": 0.0, **numbers(self._summary(low))}
        return prog, ctrl

    def _summary(self, run) -> Dict:
        return {"losses": run["losses"],
                "grad": {k: float(g.norm()) for k, g in run["grad"].items()},
                "sample": torch.cat([run["grad"][k].flatten()[:SAMPLE] for k in self.grad1]),
                "change": {k: float((p - self.motion_init[k].float()).norm())
                           for k, p in run["params"].items()}}

    def _numbers(self, got, out) -> Dict[str, float]:
        want = self._summary(out)
        g = want["grad"]
        median = float(np.median(list(g.values())))
        # leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone: out of the change's comparison
        moving = {k for k, v in g.items() if v >= 1e-3 * median}
        return {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
                "grad": ref.worst_leaf_gap(got["grad"], g),
                "grad_dir": rel(got["sample"], want["sample"]),
                "change": ref.worst_leaf_gap(got["change"], want["change"], moving)}
