"""The motion-compensated edit driver: the edit driver (``edit.py``) with
the editor's optical flow on, RAFT-large (``utils/flow.py::RaftFlow`` at
the configuration's ``RaftConfig``) from each follow-up window's query
frames to its refs, and the traffic's DDPM sampler.

A unit is one edit through the port's ``VideoEditor.__call__`` with
``use_motion_compensation=True``: its inputs from the run's seed and the
edit's index as in ``edit.py``, every normal through the editor's
``noise`` seam (the DDPM steps' among them). Beside what ``edit.py``
records, the driver keeps RAFT's flows for 8 pairs drawn from each
follow-up window, with the frames they came from.

``check`` holds one edit to the float32 references, ``reference/raft.py``
and ``reference/insv2v_flow.py``: the text, the VAE encode, the drawn
pairs' flows (``flow``: relative L2 over the reference's own with its
convolutions at TF32), the 3-way UNet output and the guided,
flow-anchored eps of two drawn steps a window (the program's recovered
from its two latents and the step's noise; the reference anchors with its
own RAFT's flows of every pair of the window), the stitch of every
window's last update into the decoder's latents, and the decode. The
control: the reference's models one precision lower in the program's
place, fp8 for those the program serves in bf16 and bf16 for RAFT, which
it runs in float32.

The cell's readers need the program's RAFT pair counter (``raft.pairs``
in ``tracing.snapshot()["counters"]``): a program without it fails the
set-up at once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from harness import Readings, derive_seed, load_module, log, seeded_weights
from reference import insv2v as ref
from reference import insv2v_flow as fl
from reference import raft as rr
from reference.ops import precision, rel, strict_fp32
from work.raft import raft_pair

base = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "edit.py"),
                   "bench_drivers_edit_base")

CHECKED_PAIRS = 8  # RAFT pairs checked a follow-up window
REF_BLOCK = 8      # pairs a block of the reference's RAFT


def raft_config(flow: dict):
    """The program's ``RaftConfig`` of the configuration's ``flow`` block."""
    from insv2v_torch.models.raft import RaftConfig

    return RaftConfig(**{f.name: flow[f.name] for f in dataclasses.fields(RaftConfig)})


def raft_weights(flow: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """RAFT's weights from ``seed``, float32: as ``seeded_weights`` makes
    them, with the cnet's frozen BatchNorm statistics and affine drawn as
    running mean 0.1 n, running variance 0.5 + U(0, 1), weight 1 + 0.1 n,
    bias 0.1 n (one draw a BatchNorm, under each of its names)."""
    from insv2v_torch.models.raft import RAFT, FrozenBatchNorm2d

    with torch.device("meta"):
        model = RAFT(raft_config(flow))
    W = seeded_weights(model, derive_seed(seed, "raft"), device, torch.float32)
    W = {k: v for k, v in W.items() if not k.endswith("num_batches_tracked")}
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "raft", "batch_norm"))
    drawn = {}
    for name, m in model.named_modules(remove_duplicate=False):
        if not isinstance(m, FrozenBatchNorm2d):
            continue
        if id(m) not in drawn:
            n = lambda: torch.randn(m.num_features, generator=gen, device=device)
            drawn[id(m)] = {"running_mean": 0.1 * n(),
                            "running_var": 0.5 + torch.rand(m.num_features, generator=gen,
                                                            device=device),
                            "weight": 1.0 + 0.1 * n(), "bias": 0.1 * n()}
        for k, v in drawn[id(m)].items():
            W[f"{name}.{k}"] = v
    return W


def span_device_s(snap: Optional[dict], name: str, units) -> tuple:
    """(device seconds summed, records) of ``name``'s spans in ``units``
    that carry a device interval, none of them profiled or failed."""
    recs = [r for r in (snap or {}).get("spans", {}).get(name, [])
            if r.unit in units and r.dev_start_ns is not None]
    if any(r.profiled or r.failed for r in recs):
        return 0.0, 0
    return sum(r.dev_end_ns - r.dev_start_ns for r in recs) / 1e9, len(recs)


def _raft_pairs() -> Optional[int]:
    from program_spans import snapshot

    snap = snapshot()
    return None if snap is None else snap.get("counters", {}).get("raft.pairs")


class Driver(base.Driver):
    """Set-up, units and check of the motion-compensated edit cell."""

    def __init__(self, cell, seed: int, device="cuda", trace: bool = False):
        super().__init__(cell, seed, device, trace)
        self.pairs_per_edit = sum((s_n - r_n) * r_n for _, s_n, r_n in self.windows)

    # --- set-up --------------------------------------------------------------

    def setup(self):
        from insv2v_torch.utils.checkpoint import load_raft_state_dict
        from insv2v_torch.utils.flow import RaftFlow

        if _raft_pairs() is None:
            raise SystemExit("edit_flow: the program counts no RAFT pairs (raft.pairs in "
                             "tracing.snapshot()['counters']), which the cell's readers need")
        # the program's float32 as PyTorch's defaults have it: TF32 in cuDNN's
        # convolutions, none in matrix products (a check before may have set both off)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        flow = self.cfg["flow"]
        self.raft_w = raft_weights(flow, self.seed, self.device)
        self.flow = RaftFlow(cfg=raft_config(flow), allow_random=True, device=self.device)
        load_raft_state_dict(self.flow.model, self.raft_w)
        self._hook_flow(self.flow)
        super().setup()
        self.pairs_at_window = _raft_pairs()

    def _edit_kwargs(self) -> dict:
        return dict(super()._edit_kwargs(), use_motion_compensation=True,
                    flow_estimator=self.flow)

    def _hook_flow(self, est):
        """Keep the drawn pairs' flows of each follow-up window (one clone
        a call), with their frames."""
        batch = est.batch

        def _batch(queries, refs):
            out = batch(queries, refs)
            rec = self._rec
            if rec is not None:
                kept = vars(rec).setdefault("pairs", {})  # window -> (queries, refs, flows)
                w = 1 + len(kept)
                rs = np.random.RandomState(derive_seed(self.seed, "pairs", rec.k, w) % 2 ** 32)
                idx = np.sort(rs.choice(len(queries), min(CHECKED_PAIRS, len(queries)),
                                        replace=False))
                kept[w] = (queries[idx], refs[idx], out[idx].clone())
            return out

        est.batch = _batch

    # --- the traced run --------------------------------------------------------

    def readings(self, r: Readings, units: int, wall: float):
        """As the edit's (the window's stages, a profiled stretch of UNet
        steps), and RAFT's device time from the window's spans: each RAFT
        call (``flow.raft``) and each iteration's lookup (``raft.lookup``),
        over the pairs the program counted in the window."""
        from program_spans import snapshot

        pairs = _raft_pairs() - self.pairs_at_window
        snap = snapshot()
        # the window's edits: the only calls with timings, so with stage spans
        edits = {rec.unit for rec in snap["spans"].get("stage.window_0", [])}
        raft_s, calls = span_device_s(snap, "flow.raft", edits)
        lookup_s, _ = span_device_s(snap, "raft.lookup", edits)
        super().readings(r, units, wall)
        log(f"RAFT in the window: {pairs} pairs ({self.pairs_per_edit} an edit x {units}), "
            f"{calls} calls, {raft_s:.4f} s on the device, lookups {lookup_s:.4f} s, "
            f"{snap['counts'].get('sampler.flow_propagate', 0)} flow_propagate spans in the run")
        if calls and pairs == units * self.pairs_per_edit:
            r.counts.update(raft_pairs=pairs, raft_calls=calls)
            r.spans.update(raft=raft_s, raft_lookup=lookup_s)
            r.work["raft"] = [self.pair_work()]

    def pair_work(self):
        """(operations, bytes) of one RAFT pair at the traffic's size."""
        return raft_pair(self.t["height"], self.t["width"],
                         **dataclasses.asdict(raft_config(self.cfg["flow"])))

    def flops_per_edit(self) -> float:
        """The edit's model FLOPs (``edit.py``'s count) and RAFT's, every
        pair of the edit (``work/raft.py``)."""
        return super().flops_per_edit() + self.pairs_per_edit * self.pair_work()[0]

    # --- the check ---------------------------------------------------------------

    def release(self):
        if hasattr(self, "flow"):
            del self.flow
        super().release()

    def check(self, rec=None, control: bool = False):
        """The references' numbers for one edit: {name: rel L2} for the
        program and, with ``control``, for the references one precision
        lower in the program's place (fp8; RAFT in bf16)."""
        strict_fp32()
        rec = rec or self.pick()
        c, t, W, dev = self.cfg, self.t, self.weights, self.device
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        tl, th = c["text"]["num_layers"], c["text"]["num_heads"]
        rcfg = {k: c["flow"][k] for k in ("corr_levels", "corr_radius", "iters")}
        tables = fl.ddpm_tables(t["steps"], c["diffusion"]["num_train_timesteps"],
                                c["diffusion"]["beta_start"], c["diffusion"]["beta_end"])
        h, w = t["height"] // 8, t["width"] // 8
        prog: Dict[str, float] = {}
        ctrl: Dict[str, float] = {}
        worst = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))
        with torch.no_grad():
            ids = torch.as_tensor(ref.hash_token_ids([rec.prompt, ""]), device=dev)
            text = lambda: ref.clip_text(W["text"], ids, tl, th)
            ctx = text()
            worst(prog, "text", rel(torch.stack([rec.ctx[2], rec.ctx[0]]), ctx))
            draws = [x for kind, x in rec.noise.draws if kind == "encode"]
            frames = torch.as_tensor(rec.frames, device=dev)
            # one posterior draw a chunk of frames, as the editor drew them
            starts = np.cumsum([0] + [d.shape[0] for d in draws[:-1]])
            encode = lambda: torch.cat([ref.vae_sample(W["vae"], frames[i: i + d.shape[0]], d,
                                                       vl, vb) for i, d in zip(starts, draws)])
            cond = encode()
            got = torch.cat([rec.cond[k] for k in range(len(self.windows))])
            want = torch.cat([cond[s0: s0 + s_n] for s0, s_n, _ in self.windows])
            worst(prog, "vae_encode", rel(got, want))
            if control:
                with precision("fp8"):
                    worst(ctrl, "text", rel(text(), ctx))
                    worst(ctrl, "vae_encode", rel(encode(), cond))
            # "flow": RAFT's flows of the drawn pairs, on the frames the program was
            # given, against the float32 reference's, in units of the same
            # reference's deviation with its convolutions at TF32, the precision the
            # configuration states (RAFT's updates amplify rounding by a factor the
            # seed's weights set)
            got, want, tf32, low = [], [], [], []
            for k in sorted(rec.pairs):
                qs, rs, out = rec.pairs[k]
                q, r = (torch.as_tensor(a, device=dev) for a in (qs, rs))
                got.append(out.float())
                want.append(rr.raft_flow(self.raft_w, rcfg, q, r, REF_BLOCK))
                with rr.rounded("tf32"):
                    tf32.append(rr.raft_flow(self.raft_w, rcfg, q, r, REF_BLOCK))
                if control:
                    with rr.rounded(torch.bfloat16):
                        low.append(rr.raft_flow(self.raft_w, rcfg, q, r, REF_BLOCK))
            got, want, tf32 = torch.cat(got), torch.cat(want), torch.cat(tf32)
            unit = rel(tf32, want)
            worst(prog, "flow", rel(got, want) / unit)
            epe = (got - want).norm(dim=-1)
            each = sorted(round(rel(a, b), 6) for a, b in zip(got, want))
            log(f"check flow: {got.shape[0]} pairs, rel L2 {rel(got, want):.4e}, of the TF32 "
                f"reference {unit:.4e}; a pair {each}; end-point error mean {epe.mean():.4e} px, "
                f"max {epe.max():.4e} px, |flow| mean {want.norm(dim=-1).mean():.3f} px")
            if control:
                low = torch.cat(low)
                worst(ctrl, "flow", rel(low, want) / unit)
                log(f"check flow control (bf16): rel L2 {rel(low, want):.4e}")
            # the reference's flows and masks of every pair of each follow-up window
            flows = {k: fl.window_flows(self.raft_w, rcfg, frames[s0: s0 + s_n], r_n, h, w,
                                        REF_BLOCK)
                     for k, (s0, s_n, r_n) in enumerate(self.windows) if r_n}
            for k, (fk, mk) in flows.items():
                r_n = self.windows[k][2]
                log(f"check window {k} flows: mean |flow| {fk[r_n:].norm(dim=-1).mean() * 8:.3f} "
                    f"px, query pixels whose masks sum over 0.5: "
                    f"{(mk[r_n:].sum(dim=1) > 0.5).float().mean():.4f}")
            steps_noise = [x for kind, x in rec.noise.draws if kind == "step"]
            noisy = [i for i in range(t["steps"]) if tables["var"][i] > 0]
            noise_of = lambda k, i: (steps_noise[k * len(noisy) + noisy.index(i)].float()
                                     if i in noisy else None)
            latents = rec.decode_in.reshape((1, t["frames"]) + rec.decode_in.shape[1:])

            def step(k, i):
                s0, s_n, r_n = self.windows[k]
                lat = rec.lat[(k, i)].float()[None]
                latent_ref = None
                if r_n:
                    latent_ref = torch.cat([latents[:, s0: s0 + r_n].float(),
                                            torch.zeros_like(lat[:, r_n:])], dim=1)
                return lambda: fl.flow_edit_step(
                    W["unet"], c["unet"], tables, i, lat, cond[s0: s0 + s_n][None], ctx[1:2],
                    ctx[0:1], s0, latent_ref, r_n, self.correct_until, t["text_cfg"],
                    t["video_cfg"], flows.get(k), noise_of(k, i))

            for (k, i) in sorted(rec.steps):
                # "step": the guided, flow-anchored eps each side's DDPM update used
                # (the program's recovered from its two states and the step's noise)
                e3, eps, _ = step(k, i)()
                p_eps = fl.ddpm_eps(tables, i, rec.lat[(k, i)].float()[None],
                                    rec.lat[(k, i + 1)].float()[None], noise_of(k, i))
                worst(prog, "unet", rel(rec.eps[(k, i)].float(), e3))
                worst(prog, "step", rel(p_eps, eps))
                log(f"check window {k} step {i}: unet {rel(rec.eps[(k, i)].float(), e3):.4e} "
                    f"step {rel(p_eps, eps):.4e}")
                if control:
                    with precision("fp8"):
                        ce3, ceps, _ = step(k, i)()
                    worst(ctrl, "unet", rel(ce3, e3))
                    worst(ctrl, "step", rel(ceps, eps))
                del e3, eps
            # "stitch": the decoder's latents against each window's last update
            # from the program's latent entering it, the window's new frames
            got, last, low = [], [], []
            for k, (s0, s_n, r_n) in enumerate(self.windows):
                got.append(latents[:, s0 + r_n: s0 + s_n].float())
                last.append(step(k, t["steps"] - 1)()[2][:, r_n:])
                if control:
                    with precision("fp8"):
                        low.append(step(k, t["steps"] - 1)()[2][:, r_n:])
            worst(prog, "stitch", rel(torch.cat(got, 1), torch.cat(last, 1)))
            if control:
                worst(ctrl, "stitch", rel(torch.cat(low, 1), torch.cat(last, 1)))
            decode = lambda: ref.decode_frames(W["vae"], rec.decode_in, c["scale_factor"], vl, vb)
            frames_ref = decode()
            worst(prog, "vae_decode", rel(torch.as_tensor(rec.output, device=dev), frames_ref))
            if control:
                with precision("fp8"):
                    worst(ctrl, "vae_decode", rel(decode(), frames_ref))
        return prog, ctrl
