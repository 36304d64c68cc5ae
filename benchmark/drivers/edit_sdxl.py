"""The SDXL-scale edit driver: the edit driver (``edit.py``) over the
configuration's models, the SDXL UNet3D, SDXL's two text towers and the
VAE, with the ``text_time`` inputs recorded beside the contexts.

A unit is one edit through the port's ``VideoEditor.__call__``, as in
``edit.py``: its inputs from the run's seed and the edit's index, two
checked steps of each window drawn from the seed. The recorded state adds
the pooled embeddings, the size ids and the UNet's added embedding of the
edit's first call. ``check`` holds one edit to the float32 reference
(``reference/insv2v_sdxl.py``): the text (both towers' context and the
pooled embedding, the worse of the two), the added embedding, the VAE
encode, the 3-way UNet output and the guided step at the checked steps,
and the decode.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from counters import launch_counters
from harness import Readings, derive_seed, load_module, log
from reference import insv2v as ref
from reference import insv2v_sdxl as xl
from reference.ops import precision, rel, strict_fp32
from work.sdxl import unet3d_xl_launches

base = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "edit.py"),
                   "bench_drivers_edit_base")
edit_frames, Noise = base.edit_frames, base.Noise

# the profiled stretch of the traced run: UNet steps [PROFILE_FROM, +PROFILE_STEPS)
# of an edit, then HOST_STEPS more with the host's ops traced
PROFILE_FROM, PROFILE_STEPS, HOST_STEPS = 4, 4, 2


class Driver(base.Driver):
    """Set-up, units and check of the SDXL-scale edit cell."""

    def _models(self):
        from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder, DualTextEncoder
        from insv2v_torch.models.openclip_text import OpenClipTextConfig, OpenClipTextEncoder
        from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
        from insv2v_torch.models.vae import AutoencoderKL, VaeConfig

        c = self.cfg
        tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        with torch.device("meta"):
            text = DualTextEncoder(ClipTextEncoder(ClipTextConfig(**c["text"]["clip"])),
                                   OpenClipTextEncoder(OpenClipTextConfig(**c["text"]["openclip"])))
            return {"unet": UNet3DConditionModel(UNetConfig(**tup(c["unet"]))),
                    "vae": AutoencoderKL(VaeConfig(**tup(c["vae"]))), "text": text}

    def _hook(self, editor):
        """As ``edit.py`` records, with the UNet's fifth argument (the
        ``text_time`` inputs) and, from a hook on the UNet's added
        embedding, its output in the edit's first call."""
        unet_call, decode = editor._unet, editor.decode_latents
        steps = self.t["steps"]

        def _unet(sample, t, ctx, video_start_index, added_cond=None):
            rec, p = self._rec, self._profile
            w, i = divmod(rec.calls, steps) if rec is not None else (0, 0)
            if p is not None:
                call, p.calls = p.calls, p.calls + 1
                if call >= PROFILE_FROM and p.mark(call - PROFILE_FROM):
                    raise base._StopEdit
            out = unet_call(sample, t, ctx, video_start_index, added_cond)
            if rec is not None:
                rec.calls += 1
                if i == 0:
                    if rec.ctx is None:
                        rec.ctx = ctx.clone()
                        rec.pooled = added_cond["text_embeds"].clone()
                        rec.time_ids = added_cond["time_ids"].clone()
                    rec.cond[w] = sample[1, ..., 4:].clone()
                if (w, i) in rec.steps or (w, i - 1) in rec.steps or i == steps - 1:
                    rec.lat[(w, i)] = sample[0, ..., :4].clone()
                if (w, i) in rec.steps:
                    rec.eps[(w, i)] = out.clone()
            return out

        def _added(module, inputs, out):
            rec = self._rec
            if rec is not None and getattr(rec, "add", None) is None:
                rec.add = out.float().clone()

        def _decode(latents, chunk: int = 8):
            if self._rec is not None:
                self._rec.decode_in = latents.clone()
            return decode(latents, chunk)

        editor._unet, editor.decode_latents = _unet, _decode
        editor.unet.add_embedding.register_forward_hook(_added)
        self._rec = None

    # --- the traced run --------------------------------------------------------

    def readings(self, r: Readings, units: int, wall: float):
        """Spans of the traced window, then one profiled stretch of whole
        UNet steps of a further edit."""
        from harness import Stretch

        t = self.t
        steps = t["steps"] * len(self.windows)
        sp = {}
        for tm in self.timings:
            for k, v in tm.items():
                key = "window" if k.startswith("window_") else k
                sp[key] = sp.get(key, 0.0) + v
        r.spans, r.counts = sp, {"unet_steps": steps * units}
        r.unit_wall_ms = 1e3 * sp["window"] / (steps * units)
        r.flops_per_unit = self.flops_per_edit()
        self._profile = Stretch(launch_counters, PROFILE_STEPS, HOST_STEPS)
        self._profile.calls = 0
        try:
            self.editor(edit_frames(derive_seed(self.seed, "profile"), t["frames"], t["height"],
                                    t["width"]), self.prompts[0], **self._edit_kwargs(),
                        noise=Noise(derive_seed(self.seed, "profile"), self.device))
            raise RuntimeError("the profiled edit ended before its stretch")
        except base._StopEdit:
            pass
        p, self._profile = self._profile, None
        p.fill(r)
        per_call = unet3d_xl_launches(self.cfg["unet"], 3, t["frames_per_window"],
                                      t["height"] // 8, t["width"] // 8)
        r.work = {k: v * PROFILE_STEPS for k, v in per_call.items()}
        log(f"profiled stretch: {PROFILE_STEPS} UNet steps, {len(r.trace.device_ops)} device ops, "
            f"{len(r.trace.host_ops)} host ops, launches {r.launches}, plan "
            f"{ {k: len(v) for k, v in r.work.items()} }")

    def flops_per_edit(self) -> float:
        """Model FLOPs of one edit, counted over the float32 reference on
        the meta device: the two prompts through both text towers, the VAE
        encode of every frame, every 3-way UNet call and the VAE decode of
        every frame."""
        from torch.utils.flop_counter import FlopCounterMode

        t, c = self.t, self.cfg
        meta = {n: {k: torch.empty(v.shape, device="meta") for k, v in w.items()}
                for n, w in self.weights.items()}
        f, h, w = t["frames"], t["height"], t["width"]
        fw = t["frames_per_window"]
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            ids = torch.zeros((2, 77), dtype=torch.long, device="meta")
            xl.text(self._text_weights(meta["text"]), ids, c["text"])
            ref.vae_moments(meta["vae"], torch.empty((f, h, w, 3), device="meta"), vl, vb)
            ref.vae_decode(meta["vae"], torch.empty((f, h // 8, w // 8, 4), device="meta"), vl, vb)
        fixed = counter.get_total_flops()
        counter = FlopCounterMode(display=False)
        u = c["unet"]
        with counter, torch.no_grad():
            xl.unet3d(meta["unet"], u, torch.empty((3, fw, h // 8, w // 8, 8), device="meta"),
                      torch.zeros(3, dtype=torch.long, device="meta"),
                      torch.empty((3, 77, u["cross_attention_dim"]), device="meta"), 0,
                      torch.empty((3, c["text"]["openclip"]["projection_dim"]), device="meta"),
                      torch.empty((3, 6), device="meta"))
        calls = t["steps"] * len(self.windows)
        return float(fixed + calls * counter.get_total_flops())

    # --- the check ---------------------------------------------------------------

    @staticmethod
    def _text_weights(W: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: xl.sub_weights(W, k + ".") for k in ("text_encoder", "text_encoder_2")}

    def check(self, rec=None, control: bool = False):
        """The reference's numbers for one edit: {name: rel L2} for the
        program and, with ``control``, for the reference one precision
        lower (fp8) in the program's place."""
        strict_fp32()
        rec = rec or self.pick()
        c, t, W, dev = self.cfg, self.t, self.weights, self.device
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        tables = ref.ddim_tables(t["steps"], **{k: c["diffusion"][k] for k in
                                                ("beta_start", "beta_end")})
        prog: Dict[str, float] = {}
        ctrl: Dict[str, float] = {}
        worst = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))
        both = lambda got, want: max(rel(got[0], want[0]), rel(got[1], want[1]))
        with torch.no_grad():
            ids = torch.as_tensor(ref.hash_token_ids([rec.prompt, ""]), device=dev)
            Wt = self._text_weights(W["text"])
            text = lambda: xl.text(Wt, ids, c["text"])
            ctx, pooled = text()
            # the program's 3-way rows are (uncond, uncond, cond)
            got = (torch.stack([rec.ctx[2], rec.ctx[0]]),
                   torch.stack([rec.pooled[2], rec.pooled[0]]))
            worst(prog, "text", both(got, (ctx, pooled)))
            pooled3 = torch.stack([pooled[1], pooled[1], pooled[0]])
            time_ids = xl.size_ids(t["height"], t["width"], dev)
            add = lambda: xl.add_embed(W["unet"], c["unet"], pooled3, time_ids.expand(3, -1))
            add_ref = add()
            worst(prog, "add_embed", rel(rec.add, add_ref))
            draws = torch.cat([x for kind, x in rec.noise.draws if kind == "encode"])
            frames = torch.as_tensor(rec.frames, device=dev)
            encode = lambda: xl.vae_sample_frames(W["vae"], frames, draws, vl, vb)
            cond = encode()
            got = torch.cat([rec.cond[w] for w in range(len(self.windows))])
            want = torch.cat([cond[s0: s0 + s_n] for s0, s_n, _ in self.windows])
            worst(prog, "vae_encode", rel(got, want))
            if control:
                with precision("fp8"):
                    worst(ctrl, "text", both(text(), (ctx, pooled)))
                    worst(ctrl, "add_embed", rel(add(), add_ref))
                    worst(ctrl, "vae_encode", rel(encode(), cond))
            latents = rec.decode_in.reshape((1, t["frames"]) + rec.decode_in.shape[1:])
            for (w, i) in sorted(rec.steps):
                s0, s_n, r_n = self.windows[w]
                lat = rec.lat[(w, i)].float()[None]
                latent_ref = None
                if r_n:
                    latent_ref = torch.cat([latents[:, s0: s0 + r_n].float(),
                                            torch.zeros_like(lat[:, r_n:])], dim=1)
                step = lambda: xl.edit_step(
                    W["unet"], c["unet"], tables, i, lat, cond[s0: s0 + s_n][None], ctx[1:2],
                    ctx[0:1], pooled[1:2], pooled[0:1], time_ids, s0, latent_ref, r_n,
                    self.correct_until, t["text_cfg"], t["video_cfg"])
                # "step": the guided eps each side's DDIM update used (the
                # program's recovered from its two states)
                e3, eps, _ = step()
                p_eps = ref.ddim_eps(tables, i, lat, rec.lat[(w, i + 1)].float()[None])
                worst(prog, "unet", rel(rec.eps[(w, i)].float(), e3))
                worst(prog, "step", rel(p_eps, eps))
                log(f"check window {w} step {i}: unet {rel(rec.eps[(w, i)].float(), e3):.4e} "
                    f"step {rel(p_eps, eps):.4e}")
                if control:
                    with precision("fp8"):
                        ce3, ceps, _ = step()
                    worst(ctrl, "unet", rel(ce3, e3))
                    worst(ctrl, "step", rel(ceps, eps))
                del e3, eps
            decode = lambda: xl.decode_frames(W["vae"], rec.decode_in, c["scale_factor"], vl, vb)
            frames_ref = decode()
            worst(prog, "vae_decode", rel(torch.as_tensor(rec.output, device=dev), frames_ref))
            if control:
                with precision("fp8"):
                    worst(ctrl, "vae_decode", rel(decode(), frames_ref))
        return prog, ctrl
