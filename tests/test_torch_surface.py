"""The port's surface against the JAX package's, read with ``ast`` alone
(neither package is imported): every public top-level function or class
of every module under ``insv2v_tpu/``, and every module, has a definition
of the same name at the same path under ``insv2v_torch/``, or a checked
entry in COUNTERPARTS (another name or place in the port), or a reasoned
entry in NO_COUNTERPART. Methods and nested functions are not read.

Keys are ``"<path under the package>:<name>"`` or, for a whole module,
``"<path>"``. A module mapped to another in COUNTERPARTS has its names
looked up there first; a module in NO_COUNTERPART covers its names."""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "insv2v_tpu")
PORT_ROOT = os.path.join(REPO, "insv2v_torch")

COUNTERPARTS = {
    "ops/attention.py:packed_temporal_attention": "ops/attention.py:temporal_attention",
    "ops/attention.py:packed_temporal_attention_xla":
        "ops/attention.py:temporal_attention_reference",
    "training/quantized_adam.py:adam8bit": "training/quantized_adam.py:Adam8bit",
    # torch.distributed process groups in place of a device mesh; its
    # init_distributed and assert_zero_sharded keep their names there
    "parallel/mesh.py": "parallel/dist.py",
    "parallel/mesh.py:make_global_batch": "parallel/dist.py:local_batch_slice",
    "models/raft.py:ResidualUnit": "models/raft.py:ResidualBlock",
    "models/raft.py:FrozenBatchNorm": "models/raft.py:FrozenBatchNorm2d",
    "models/t5_text.py:T5SelfAttention": "models/t5_text.py:T5Attention",
    "utils/checkpoint.py:load_pipeline_params": "utils/checkpoint.py:load_pipeline_state_dicts",
    "utils/checkpoint.py:merge_params": "utils/checkpoint.py:load_into",
    # the port's convert.py goes the other way (Flax -> torch); the
    # loader's helpers sit beside the loader
    "utils/convert.py:strip_prefixes": "utils/checkpoint.py:strip_prefixes",
    "utils/convert.py:merge_unet_motion_state_dicts":
        "utils/checkpoint.py:merge_unet_motion_state_dicts",
    # the YAML's params -> the model's config; build_models makes the three
    "utils/factory.py:build_unet3d": "utils/factory.py:unet_config",
    "utils/factory.py:build_vae": "utils/factory.py:vae_config",
    "utils/factory.py:build_text_model": "utils/factory.py:build_models",
    "utils/factory.py:get_models": "utils/factory.py:build_models",
    "utils/factory.py:get_dataset": "data/datasets.py:dataset_from_config",
}

_FLAX_NORM = "a Flax wrapper of a norm; the port uses torch's own module"
_TO_FLAX = ("a torch -> Flax key converter; the port keeps the reference's torch key "
            "layout, and its convert.py goes the other way (torch_state_dict_from_flax)")
_GSPMD = "a GSPMD mesh or sharding helper; the port shards with torch.distributed groups"

NO_COUNTERPART = {
    "apps/convert_checkpoint.py": "converts torch weights to an orbax tree; the port loads "
                                  "the torch checkpoints directly",
    "utils/aot_cache.py": "the JAX ahead-of-time compile cache; nothing is compiled ahead",
    "utils/jax_cache.py": "the JAX persistent compilation cache",
    "utils/registry.py": "the Flax factory's name registry; the port's factory builds from "
                         "the YAML's params directly",
    "utils/profiling.py": "PhaseTimer and device_trace are used by no module of the JAX "
                          "package; the port records stage_seconds, and chip_smoke.py "
                          "traces with torch.profiler",
    "utils/baseline.py": "the A100 throughput estimate of the JAX bench; it belongs to the "
                         "port's bench, which is still to come",
    "parallel/mesh.py:make_mesh": _GSPMD,
    "parallel/mesh.py:batch_sharding": _GSPMD,
    "parallel/mesh.py:replicated": _GSPMD,
    "parallel/mesh.py:shard_leaf_spec": _GSPMD,
    "parallel/mesh.py:zero_sharded_like": _GSPMD,
    "parallel/mesh.py:constrain_zero_sharding": _GSPMD,
    "training/quantized_adam.py:Adam8bitState": "the optax state of adam8bit; Adam8bit keeps "
                                                "its state in the torch optimizer's own",
    "models/clip_text.py:LayerNorm": _FLAX_NORM,
    "models/modelscope_t2v.py:GroupNorm": _FLAX_NORM,
    "models/modelscope_t2v.py:LayerNorm": _FLAX_NORM,
    "models/openclip_text.py:LayerNorm": _FLAX_NORM,
    "models/vae.py:GroupNorm": _FLAX_NORM,
    "models/vae.py:swish": "jax's x * sigmoid(x); the port calls torch's silu",
    "models/raft.py:instance_norm": "InstanceNorm2d without affine; the port calls "
                                    "torch's F.instance_norm",
    "utils/convert.py:nest": "builds a nested Flax tree from '/'-joined keys",
    "utils/convert.py:convert_clip_model_state_dict": _TO_FLAX,
    "utils/convert.py:convert_clip_text_state_dict": _TO_FLAX,
    "utils/convert.py:convert_openclip_text_state_dict": _TO_FLAX,
    "utils/convert.py:convert_raft_state_dict": _TO_FLAX,
    "utils/convert.py:convert_t5_state_dict": _TO_FLAX,
    "utils/convert.py:convert_unet3d_state_dict": _TO_FLAX,
    "utils/convert.py:convert_unet_sd_state_dict": _TO_FLAX,
    "utils/convert.py:convert_vae_state_dict": _TO_FLAX,
    "ops/attention.py:logits_bf16": "whether XLA stores attention logits in bf16 on a TPU",
    "ops/attention.py:dispatch_packed_temporal": "picks the Pallas kernel on a TPU, XLA "
                                                 "elsewhere; the port's temporal_attention "
                                                 "picks by the tensor's device",
    "data/native_loader.py:native_available": "a probe for the fallback to numpy; the port's "
                                              "native_loader.load() raises instead",
}


def _modules(root):
    """{path under root: set of public top-level def and class names}."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build"))
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                out[os.path.relpath(path, root).replace(os.sep, "/")] = {
                    n.name for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not n.name.startswith("_")}
    return out


JAX, PORT = _modules(JAX_ROOT), _modules(PORT_ROOT)


def _jax_keys():
    keys = set(JAX)
    keys.update(f"{mod}:{name}" for mod, names in JAX.items() for name in names)
    return keys


def _port_has(target):
    mod, _, name = target.partition(":")
    return mod in PORT and (not name or name in PORT[mod])


def _by_name(key):
    """Whether the port defines the key's name at its path (or, for a
    name, in the port module its JAX module maps to)."""
    mod, _, name = key.partition(":")
    if not name:
        return mod in PORT
    return name in PORT.get(COUNTERPARTS.get(mod, mod), ())


def _answered(key):
    mod, _, name = key.partition(":")
    return (key in COUNTERPARTS or key in NO_COUNTERPART or _by_name(key)
            or (bool(name) and mod in NO_COUNTERPART))


def test_the_audit_reads_both_packages():
    assert len(JAX) > 40 and sum(map(len, JAX.values())) > 200
    assert "VideoEditor" in PORT["diffusion/pipeline.py"]


def test_every_public_jax_name_has_a_port_answer():
    missing = sorted(k for k in _jax_keys() if not _answered(k))
    assert not missing, (
        f"no definition of these names at these paths of the port: {missing}; port each, or "
        f"add it to COUNTERPARTS (its port name) or NO_COUNTERPART (why there is none)")


def test_each_counterpart_exists_in_the_port():
    absent = sorted(f"{k} -> {v}" for k, v in COUNTERPARTS.items() if not _port_has(v))
    assert not absent, f"counterparts the port does not define: {absent}"


def test_no_stale_or_idle_entry():
    """Every entry names a public JAX name or module that still exists,
    says why where it is a NO_COUNTERPART, and is needed: a key the port
    now matches by name belongs in neither table."""
    keys = _jax_keys()
    assert not set(COUNTERPARTS) & set(NO_COUNTERPART)
    stale = sorted(k for k in (*COUNTERPARTS, *NO_COUNTERPART) if k not in keys)
    assert not stale, f"entries for names the JAX package no longer has: {stale}"
    assert all(reason.strip() for reason in NO_COUNTERPART.values())
    idle = sorted(k for k in (*COUNTERPARTS, *NO_COUNTERPART) if _by_name(k))
    assert not idle, f"entries the port now matches by name: {idle}"
