"""The data-generation driver: prompt-to-prompt pairs back to back, each
through the attempt body of the port's ``apps/generate_dataset.py``.

A unit is one pair: the caption diff and the OpenCLIP text encodes with
the token-aligned (key, value) contexts, ``sample_ptp_pair`` (v2, the
three phases) from the pair's initial latent, the VAE decode of both
videos, the four CLIP scores, and the pair written as an accepted pair is
(both videos as JPEGs and the GIF, under ``TMPDIR``). Each pair draws its
hyper-parameters as the generator does (``hyper_draws``, copied here) from
a ``RandomState`` of the run's seed, and its caption triple from the
traffic's file. The driver records the contexts, the chain's (old, new)
latents at every step, the UNetSD outputs of one drawn step of each
phase, the decoded videos and the scores; ``check`` holds one pair,
drawn from the seed, to the float32 reference
(``reference/modelscope.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from counters import launch_counters
from harness import Readings, derive_seed, load_weights, log, seeded_weights
from reference import insv2v as ref_v2v
from reference import modelscope as ref
from reference.ops import precision, rel, strict_fp32

# the profiled stretch of the traced run: sampler steps [PROFILE_FROM,
# +PROFILE_STEPS) of a further pair, its phase-1 steps (4-way calls), then
# HOST_STEPS more with the host's ops traced
PROFILE_FROM, PROFILE_STEPS, HOST_STEPS = 2, 6, 2


def hyper_draws(rs):
    """One attempt's (seed, guidance, sa_end, ca_end, edit_weight) from the
    run's ``RandomState``, in the reference's order and on its grids
    (video_prompt_to_prompt.py:178-182)."""
    seed = int(rs.randint(0, 2 ** 31 - 1))
    guidance = float(rs.randint(5, 13))
    sa_end = round(float(rs.choice(np.linspace(0.3, 0.45, 4))), 2)
    ca_end = round(float(rs.choice(np.linspace(0.6, 0.85, 6))), 2)
    edit_weight = float(rs.randint(1, 6))
    return seed, guidance, sa_end, ca_end, edit_weight


def phase_steps(frac: float, steps: int) -> int:
    """Steps before fraction ``frac``: ``i < frac * steps`` counted."""
    return sum(1 for i in range(steps) if i < frac * steps)


class _StopPair(Exception):
    """Ends the profiled pair once its stretch is over."""


class Record:
    def __init__(self, k, triple, draws):
        self.k, self.triple, self.draws = k, triple, draws
        self.ctx: Dict[str, torch.Tensor] = {}
        self.states: List[tuple] = []            # (old, new) entering each step
        self.eps: Dict[int, Dict[str, torch.Tensor]] = {}
        self.phases = (0, 0)
        self.final = None
        self.frames: Dict[str, np.ndarray] = {}
        self.scores: Dict[str, float] = {}
        self.check_steps: List[int] = []


class Driver:
    unit = "pair"

    def __init__(self, cell, seed: int, device="cuda", trace: bool = False):
        self.cell, self.seed, self.trace = cell, int(seed), trace
        self.device = torch.device(device)
        self.t, self.cfg = cell.traffic, cell.config
        self.dtype = getattr(torch, self.cfg["dtype"])
        with open(cell.path(self.t["prompts"])) as f:
            self.triples = json.load(f)
        self.rs = np.random.RandomState(derive_seed(self.seed, "hyper") % 2 ** 32)
        self.records: List[Record] = []
        self.timings: List[dict] = []
        self._rec: Optional[Record] = None
        self._profile = None
        self.out_dir = tempfile.mkdtemp(prefix="bench_pairs_")

    # --- set-up --------------------------------------------------------------

    def _models(self):
        from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
        from insv2v_torch.models.clip_vision import (ClipTextProjection, ClipVisionConfig,
                                                     ClipVisionEncoder, ClipVisionProjection)
        from insv2v_torch.models.modelscope_t2v import ModelScopeConfig, UNetSD
        from insv2v_torch.models.openclip_text import OpenClipTextConfig, OpenClipTextEncoder
        from insv2v_torch.models.vae import AutoencoderKL, VaeConfig

        c = self.cfg
        tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        sc = c["scorer"]
        vcfg = ClipVisionConfig(hidden_size=sc["hidden_size"], num_layers=sc["num_layers"],
                                num_heads=sc["num_heads"], intermediate_size=sc["intermediate_size"],
                                image_size=sc["image_size"], patch_size=sc["patch_size"],
                                projection_dim=sc["projection_dim"])
        tcfg = ClipTextConfig(**sc["text"])
        with torch.device("meta"):
            served = {"unet": UNetSD(ModelScopeConfig(**tup(c["unet"]))),
                      "vae": AutoencoderKL(VaeConfig(**tup(c["vae"]))),
                      "text": OpenClipTextEncoder(OpenClipTextConfig(**c["text"]))}
            scorer = {"text": ClipTextEncoder(tcfg), "vision": ClipVisionEncoder(vcfg),
                      "visual_projection": ClipVisionProjection(vcfg.hidden_size,
                                                                vcfg.projection_dim),
                      "text_projection": ClipTextProjection(tcfg.hidden_size, vcfg.projection_dim)}
        return served, scorer

    def setup(self):
        from insv2v_torch.diffusion.schedules import DiffusionSchedule, make_sampler_tables
        from insv2v_torch.text.tokenizer import HashTokenizer
        from insv2v_torch.utils.clip_metrics import ClipSimilarity

        t0 = time.perf_counter()
        served, scorer = self._models()
        self.weights = {n: seeded_weights(m, derive_seed(self.seed, n), self.device, self.dtype)
                        for n, m in served.items()}
        # the scorer is served in float32, as the generator serves it
        scorer_w = {n: seeded_weights(m, derive_seed(self.seed, "clip", n), self.device,
                                      torch.float32) for n, m in scorer.items()}
        # the towers' keys are the HF CLIPModel's, so one dict holds them all
        self.clip_weights = {k: v for w in scorer_w.values() for k, v in w.items()}
        for n, m in served.items():
            load_weights(m, self.weights[n])
        for n, m in scorer.items():
            load_weights(m, scorer_w[n])
        self.models = {n: m.eval() for n, m in served.items()}
        self.tokenizer = HashTokenizer()
        self.clip = ClipSimilarity({n: m.eval() for n, m in scorer.items()},
                                   tokenizer=self.tokenizer, device=self.device)
        d = self.cfg["diffusion"]
        schedule = DiffusionSchedule.create(beta_schedule=d["beta_schedule"],
                                            beta_start=d["beta_start"], beta_end=d["beta_end"])
        self.tables = make_sampler_tables(schedule, self.t["steps"], "ddim")
        log(f"weights: {sum(v.numel() for w in self.weights.values() for v in w.values()) / 1e6:.1f}"
            f" M served in {self.dtype}, {sum(v.numel() for v in self.clip_weights.values()) / 1e6:.1f}"
            f" M scorer in float32, {time.perf_counter() - t0:.2f} s")
        # every shape of the window once: a three-step pair, one step a phase
        t0 = time.perf_counter()
        self._pair(-1, self.triples[0], (0, 7.5, 0.0, 0.0, 2.0), phases=(1, 2),
                   tables=make_sampler_tables(schedule, 3, "ddim"))
        torch.cuda.synchronize() if self.device.type == "cuda" else None
        log(f"warm-up pair: {time.perf_counter() - t0:.2f} s")

    # --- units -----------------------------------------------------------------

    def _unet(self, x, t, c, share):
        rec, p = self._rec, self._profile
        if p is not None and p.step >= PROFILE_FROM and p.step != p.marked:
            p.marked = p.step
            if p.mark(p.step - PROFILE_FROM):
                raise _StopPair
        out = self.models["unet"](x, t, c, sa_share=share)
        if rec is not None and p is None:
            i = len(rec.states) - 1
            if i in rec.check_steps:
                key = "joint" if share else ("old" if rec.eps.get(i) is None else "new")
                rec.eps.setdefault(i, {})[key] = out.clone()
        return out

    def _noise(self, gen):
        """The sampler's noise seam: both branches' normals from the pair's
        generator; each call opens a step, whose (old, new) the unet hook
        reads from the inputs that follow."""
        def draw(i, shape):
            if self._profile is not None:
                self._profile.step = i
            mk = lambda: torch.randn(tuple(shape), generator=gen, device=gen.device,
                                     dtype=torch.float32)
            return mk(), mk()
        return draw

    def _pair(self, k: int, triple: dict, draws, phases=None, rec: Optional[Record] = None,
              timings: Optional[dict] = None, tables=None):
        from insv2v_torch.diffusion.ptp_sampler import sample_ptp_pair
        from insv2v_torch.text.prompt_diff import build_ptp_key_value, compute_diff
        from insv2v_torch.utils.media import save_gif, to_uint8

        import cv2

        dev, tok, t = self.device, self.tokenizer, self.t
        tables = tables or self.tables
        steps = tables.num_steps
        seed, guidance, sa_end, ca_end, edit_weight = draws
        text = self.models["text"]
        sync = (lambda: torch.cuda.synchronize(dev)) if (timings is not None and dev.type == "cuda") \
            else (lambda: None)
        clock = lambda: (sync(), time.perf_counter())[1]
        t0 = clock()
        with torch.no_grad():
            encode = lambda ids: text(torch.as_tensor(np.asarray(ids), device=dev))
            pieces = compute_diff(triple["input"], triple["output"])
            for piece in pieces:
                if piece.old != piece.new:
                    piece.weight = edit_weight
            ctx_old = encode(tok([triple["input"]]))
            ctx_new = encode(tok([triple["output"]]))
            ctx_un = encode(tok([""]))
            key, val = build_ptp_key_value(pieces, tok,
                                           lambda ids: encode(ids).float().cpu().numpy())
            kv = (torch.as_tensor(key, device=dev), torch.as_tensor(val, device=dev))
            t1 = clock()
            gen = torch.Generator(device=dev).manual_seed(seed)
            hw = t["latent_size"]
            lat = torch.randn((1, t["frames"], hw, hw, 4), generator=gen, device=dev)
            if phases is None:
                sa = phase_steps(sa_end, steps)
                ca = min(max(phase_steps(ca_end, steps), sa + 1), steps)
            else:
                sa, ca = phases
            if rec is not None:
                rec.ctx = {"old": ctx_old.clone(), "new": ctx_new.clone(), "un": ctx_un.clone(),
                           "key": kv[0].clone(), "value": kv[1].clone()}
                rec.phases = (sa, ca)
                # one checked step in each phase
                rs = np.random.RandomState(derive_seed(self.seed, "steps", k) % 2 ** 32)
                rec.check_steps = [int(rs.randint(lo, hi)) for lo, hi in
                                   ((0, sa), (sa, ca), (ca, steps)) if lo < hi]
            stages = {}
            out = sample_ptp_pair(self._recording_unet(rec), tables, lat, ctx_new, ctx_old,
                                  kv, ctx_un, guidance_scale=guidance, sa_steps=sa, ca_steps=ca,
                                  noise=self._noise(gen),
                                  timings=stages if timings is not None else None)
            t2 = clock()
            z = {"0": out["latent_old"], "1": out["latent"]}
            frames = {tag: self.models["vae"].decode(v[0] / self.cfg["scale_factor"]).float()
                      .clamp(-1, 1).cpu().numpy() for tag, v in z.items()}
            t3 = clock()
        s = self.clip(frames["0"], frames["1"], [triple["input"]], [triple["output"]])
        scores = dict(sim_0=float(np.mean(s["sim_0"])), sim_1=float(np.mean(s["sim_1"])),
                      sim_dir=float(np.mean(s["sim_direction"])),
                      sim_image=float(np.mean(s["sim_image"])))
        t4 = clock()
        out_dir = os.path.join(self.out_dir, f"pair_{k:06d}")
        os.makedirs(out_dir, exist_ok=True)
        for tag in ("0", "1"):
            for i, fr in enumerate(to_uint8(frames[tag])):
                cv2.imwrite(os.path.join(out_dir, f"{seed}_{tag}_{i:04d}.jpg"),
                            cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
        save_gif(frames["1"], os.path.join(out_dir, f"{seed}.gif"))
        shutil.rmtree(out_dir)
        t5 = clock()
        if rec is not None:
            rec.final = (z["0"].clone(), z["1"].clone())
            rec.frames, rec.scores = frames, scores
        if timings is not None:
            timings.update(stages, text=t1 - t0, sample=t2 - t1, decode=t3 - t2, score=t4 - t3,
                           write=t5 - t4, calls=sa + 2 * (steps - sa))
        return scores

    def _recording_unet(self, rec: Optional[Record]):
        """The UNet as the sampler calls it; with a record, the (old, new)
        latents entering each step are read off its inputs."""
        def call(x, t, c, share):
            if rec is not None:
                if share:
                    rec.states.append((x[0:1].float().clone(), x[1:2].float().clone()))
                elif len(rec.states) == 0 or rec.states[-1][1] is not None:
                    rec.states.append((x[0:1].float().clone(), None))
                else:
                    rec.states[-1] = (rec.states[-1][0], x[0:1].float().clone())
            self._rec = rec
            try:
                return self._unet(x, t, c, share)
            finally:
                self._rec = None
        return call

    def run_unit(self, k: int) -> int:
        triple = self.triples[int(np.random.RandomState(
            derive_seed(self.seed, "triple", k) % 2 ** 32).randint(len(self.triples)))]
        draws = hyper_draws(self.rs)
        rec = Record(k, triple, draws)
        timings = {} if self.trace else None
        self._pair(k, triple, draws, rec=rec, timings=timings)
        self.records.append(rec)
        if timings is not None:
            self.timings.append(timings)
        return 1

    def end_to_end(self, units: int, wall: float) -> Dict[str, float]:
        return {"datagen_pairs_per_min": 60.0 * units / wall}

    def describe(self, units: int, wall: float) -> List[str]:
        lines = [f"pairs {units} in {wall:.3f} s: {wall / units:.3f} s a pair"]
        for rec, tm in zip(self.records, self.timings):
            lines.append(f"pair {rec.k} draws {rec.draws} stages: "
                         + ", ".join(f"{a} {b:.3f}" for a, b in tm.items()))
        return lines

    # --- the traced run --------------------------------------------------------

    def readings(self, r: Readings, units: int, wall: float):
        from harness import Stretch
        from work.kernels import unetsd_launches

        sp = {}
        for tm in self.timings:
            for k, v in tm.items():
                sp[k] = sp.get(k, 0.0) + v
        r.spans = sp
        r.counts = {"unetsd_calls": sp.get("calls", 0)}
        phase1 = sum(rec.phases[0] for rec in self.records)
        r.unit_wall_ms = 1e3 * sp["phase1"] / phase1
        r.flops_per_unit = self.flops_per_pair()
        # a pair whose first PROFILE_FROM + PROFILE_STEPS steps are phase 1
        self._profile = Stretch(launch_counters, PROFILE_STEPS, HOST_STEPS)
        self._profile.step, self._profile.marked = -1, -1
        try:
            self._pair(-2, self.triples[0], (derive_seed(self.seed, "profile") % 2 ** 31, 9.0,
                                             0.45, 0.85, 2.0))
            raise RuntimeError("the profiled pair ended before its stretch")
        except _StopPair:
            pass
        p, self._profile = self._profile, None
        p.fill(r)
        t = self.t
        per_call = unetsd_launches(self.cfg["unet"], 4, t["frames"], t["latent_size"],
                                   t["latent_size"])
        r.work = {k: v * PROFILE_STEPS for k, v in per_call.items()}
        log(f"profiled stretch: {PROFILE_STEPS} phase-1 steps, {len(r.trace.device_ops)} device "
            f"ops, {len(r.trace.host_ops)} host ops, launches {r.launches}")

    def flops_per_pair(self) -> float:
        """Model FLOPs of a pair at the mean phase lengths of the pairs run
        (counted over the reference on the meta device): the text encodes,
        the UNetSD calls (4-way in phase 1, two 2-way after), the VAE
        decode of both videos and the CLIP features of both."""
        from torch.utils.flop_counter import FlopCounterMode

        t, c = self.t, self.cfg
        meta = lambda w: {k: torch.empty(v.shape, device="meta") for k, v in w.items()}
        mw = {n: meta(w) for n, w in self.weights.items()}
        f, hw = t["frames"], t["latent_size"]

        def count(fn):
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                fn()
            return counter.get_total_flops()

        ids = lambda b: torch.zeros((b, 77), dtype=torch.long, device="meta")
        x = lambda b: torch.empty((b, f, hw, hw, 4), device="meta")
        tt = lambda b: torch.zeros(b, device="meta")
        ctx = lambda b: torch.empty((b, 77, c["unet"]["context_dim"]), device="meta")
        text = count(lambda: ref.openclip_text(mw["text"], ids(5), c["text"]["num_layers"],
                                               c["text"]["num_heads"]))
        four = count(lambda: ref.unetsd(mw["unet"], c["unet"], x(4), tt(4), ctx(4), True))
        two = count(lambda: ref.unetsd(mw["unet"], c["unet"], x(2), tt(2), ctx(2)))
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        dec = count(lambda: ref_v2v.vae_decode(mw["vae"], torch.empty((2 * f, hw, hw, 4),
                                                                      device="meta"), vl, vb))
        sc = c["scorer"]
        cw = meta(self.clip_weights)
        clip = count(lambda: ref.clip_image_features(cw, torch.empty((2 * f, 8 * hw, 8 * hw, 3),
                                                                     device="meta"), sc))
        sa = np.mean([r.phases[0] for r in self.records]) if self.records else t["steps"] / 3
        return float(text + sa * four + 2 * (t["steps"] - sa) * two + dec + clip)

    # --- the check ---------------------------------------------------------------

    def release(self):
        for name in ("models", "clip"):
            if hasattr(self, name):
                delattr(self, name)
        shutil.rmtree(self.out_dir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def pick(self) -> Record:
        rs = np.random.RandomState(derive_seed(self.seed, "check") % 2 ** 32)
        return self.records[rs.randint(len(self.records))]

    def check(self, rec: Optional[Record] = None, control: bool = False):
        """{name: number} for the program and, with ``control``, for the
        reference one precision lower (fp8) in the program's place: rel L2
        of the text contexts, the UNetSD outputs and the step updates at
        the drawn steps, the decoded videos; the largest gap of a CLIP
        score."""
        strict_fp32()
        rec = rec or self.pick()
        c, t, dev = self.cfg, self.t, self.device
        W, CW = self.weights, self.clip_weights
        tc, sc = c["text"], c["scorer"]
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        tables = ref_v2v.ddim_tables(t["steps"], **{k: c["diffusion"][k] for k in
                                                    ("beta_start", "beta_end")})
        ids_of = lambda s: torch.as_tensor(ref_v2v.hash_token_ids([s]), device=dev)
        count = lambda s: len(s.strip().lower().split())
        triple = rec.triple
        prog: Dict[str, float] = {}
        ctrl: Dict[str, float] = {}
        worst = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))

        def contexts():
            enc = lambda ids: ref.openclip_text(W["text"], ids, tc["num_layers"], tc["num_heads"])
            pieces = ref.word_pieces(triple["input"], triple["output"])
            key, value = ref.ptp_key_value(pieces, rec.draws[4], count, ids_of, enc)
            return {"old": enc(ids_of(triple["input"])), "new": enc(ids_of(triple["output"])),
                    "un": enc(ids_of("")), "key": key, "value": value}

        with torch.no_grad():
            ctx = contexts()
            for k in ctx:
                worst(prog, "text", rel(rec.ctx[k].float(), ctx[k]))
            if control:
                with precision("fp8"):
                    cctx = contexts()
                for k in ctx:
                    worst(ctrl, "text", rel(cctx[k], ctx[k]))
            sa, ca = rec.phases
            states = rec.states + [rec.final]
            for i in rec.check_steps:
                phase = 1 if i < sa else (2 if i < ca else 3)
                old, new = states[i]
                step = lambda: ref.ptp_step(W["unet"], c["unet"], tables, i, phase, old, new, ctx,
                                            rec.draws[1])
                # "step": the guided eps each side's DDIM updates used (the
                # program's recovered from its two states)
                eps, guided, _, _ = step()
                want = torch.cat(guided)
                p_old, p_new = (s.float() for s in states[i + 1])
                got = torch.cat([ref_v2v.ddim_eps(tables, i, old, p_old),
                                 ref_v2v.ddim_eps(tables, i, new, p_new)])
                for key, e in eps.items():
                    worst(prog, "unet", rel(rec.eps[i][key].float(), e))
                worst(prog, "step", rel(got, want))
                log(f"check step {i} (phase {phase}): unet "
                    f"{max(rel(rec.eps[i][k].float(), e) for k, e in eps.items()):.4e} "
                    f"step {rel(got, want):.4e}")
                if control:
                    with precision("fp8"):
                        ceps, cguided, _, _ = step()
                    for key, e in eps.items():
                        worst(ctrl, "unet", rel(ceps[key], e))
                    worst(ctrl, "step", rel(torch.cat(cguided), want))
            z = torch.cat([rec.final[0][0], rec.final[1][0]])
            decode = lambda: ref_v2v.decode_frames(W["vae"], z, c["scale_factor"], vl, vb)
            frames = decode()
            got = torch.as_tensor(np.concatenate([rec.frames["0"], rec.frames["1"]]), device=dev)
            worst(prog, "vae_decode", rel(got, frames))
            if control:
                with precision("fp8"):
                    worst(ctrl, "vae_decode", rel(decode(), frames))
            f0, f1 = (torch.as_tensor(rec.frames[k], device=dev) for k in ("0", "1"))
            score = lambda: ref.clip_scores(CW, sc, f0, f1, ids_of(triple["input"]),
                                            ids_of(triple["output"]))
            want = score()
            worst(prog, "clip", max(abs(rec.scores[k] - want[k]) for k in want))
            if control:
                with precision("fp8"):
                    got_c = score()
                worst(ctrl, "clip", max(abs(got_c[k] - want[k]) for k in want))
        return prog, ctrl

