"""The port's weights bridge, its copy of the reference-checkpoint converter,
its device handling, and what the package may import."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pope_tpu.models.dinov2.convert import convert_torch_dinov2_state as jax_convert_dinov2
from pope_tpu.models.matcher.convert import convert_torch_matcher_state as jax_convert_matcher
from pope_tpu.models.sam.convert import convert_torch_sam_state as jax_convert
from pope_tpu.utils.state_manifest import load_state_manifest
from pope_tpu_torch.config import DinoV2Config, MatcherConfig, PipelineConfig, SamConfig, SamEncoderConfig
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer, convert_torch_dinov2_state
from pope_tpu_torch.models.matcher import Matcher, convert_torch_matcher_state
from pope_tpu_torch.models.sam import Sam
from pope_tpu_torch.models.sam.convert import convert_torch_sam_state
from pope_tpu_torch.pipeline import load_models
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax, params_state_from_jax, sam_state_from_jax
from tests.test_torch_common import jax_params, port_sam, tiny_cfg

ROOT = Path(__file__).resolve().parents[1]
DEPTH = 2  # blocks of ViT-B kept in the synthetic checkpoint


def _reference_checkpoint(seed=0):
    """A random state dict in the released sam_vit_b layout (the JAX
    package's key/shape manifest), cut to the first DEPTH encoder blocks."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in load_state_manifest("sam_vit_b").items():
        m = re.match(r"image_encoder\.blocks\.(\d+)\.", key)
        if m and int(m.group(1)) >= DEPTH:
            continue
        sd[key] = rng.standard_normal(shape, dtype=np.float32)
    return sd


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converter_copy_matches_jax_converter():
    sd = _reference_checkpoint()
    ours = dict(_flatten(convert_torch_sam_state(sd, depth=DEPTH)))
    ref = dict(_flatten(jax_convert(sd, depth=DEPTH)))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg="/".join(k))


def test_reference_checkpoint_loads_strictly():
    """checkpoint -> converter -> bridge fills every parameter of the port's
    Sam, and Linear and conv weights come out in the checkpoint's own layout."""
    sd = _reference_checkpoint(1)
    enc = SamEncoderConfig.vit_b()
    cfg = SamConfig(encoder=SamEncoderConfig(
        embed_dim=enc.embed_dim, depth=DEPTH, num_heads=enc.num_heads,
        global_attn_indexes=enc.global_attn_indexes,
    ))
    sam = Sam(cfg)
    sam.load_state_dict(sam_state_from_jax(convert_torch_sam_state(sd, depth=DEPTH)), strict=True)
    state = sam.state_dict()
    same = {
        "image_encoder.block_1.qkv.weight": "image_encoder.blocks.1.attn.qkv.weight",
        "image_encoder.patch_embed.weight": "image_encoder.patch_embed.proj.weight",
        "image_encoder.neck_conv2.weight": "image_encoder.neck.2.weight",
        "image_encoder.block_0.rel_pos_h": "image_encoder.blocks.0.attn.rel_pos_h",
        "prompt_encoder.mask_conv1.weight": "prompt_encoder.mask_downscaling.0.weight",
        "mask_decoder.transformer.layer_1.cross_attn_i2t.v_proj.weight":
            "mask_decoder.transformer.layers.1.cross_attn_image_to_token.v_proj.weight",
        "mask_decoder.hyper_2.lin1.weight": "mask_decoder.output_hypernetworks_mlps.2.layers.1.weight",
    }
    for ours, ref in same.items():
        np.testing.assert_array_equal(state[ours].numpy(), sd[ref])
    # ConvTranspose2d (in, out, kh, kw) -> the JAX (kh, kw, in, out) kernel
    np.testing.assert_array_equal(
        state["mask_decoder.up_conv1.kernel"].numpy(),
        sd["mask_decoder.output_upscaling.0.weight"].transpose(2, 3, 0, 1),
    )


def _manifest_checkpoint(name, seed, keep=lambda key: True):
    """A random state dict in a released file's key/shape layout (the JAX
    package's manifest): float leaves N(0, 1), BatchNorm variances positive."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in load_state_manifest(name).items():
        if not keep(key):
            continue
        if key.endswith("num_batches_tracked"):
            sd[key] = np.asarray(7, np.int64)
        elif key.endswith("running_var"):
            sd[key] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            sd[key] = rng.standard_normal(shape, dtype=np.float32)
    return sd


def test_dinov2_checkpoint_round_trip():
    """dinov2_vits14 layout, cut to DEPTH blocks -> the copied converter (equal
    to pope_tpu's) -> the bridge: loads strictly, with Linear and conv
    weights, LayerScale gammas and the tokens equal to the file's."""
    sd = _manifest_checkpoint("dinov2_vits14", 2, lambda k: not re.match(rf"blocks\.([{DEPTH}-9]|1\d)\.", k))
    ours = convert_torch_dinov2_state(sd, depth=DEPTH)
    ref = dict(_flatten(jax_convert_dinov2(sd, depth=DEPTH)))
    assert dict(_flatten(ours)).keys() == ref.keys()
    for k, v in _flatten(ours):
        np.testing.assert_array_equal(v, ref[k], err_msg="/".join(k))
    model = DinoVisionTransformer(DinoV2Config(depth=DEPTH))
    model.load_state_dict(dinov2_state_from_jax(ours), strict=True)
    state = model.state_dict()
    same = {
        "block_1.attn.qkv.weight": "blocks.1.attn.qkv.weight",
        "block_0.attn.proj.weight": "blocks.0.attn.proj.weight",
        "block_1.mlp_fc2.weight": "blocks.1.mlp.fc2.weight",
        "block_0.ls1.gamma": "blocks.0.ls1.gamma",
        "block_1.ls2.gamma": "blocks.1.ls2.gamma",
        "patch_embed.weight": "patch_embed.proj.weight",
        "cls_token": "cls_token", "mask_token": "mask_token", "pos_embed": "pos_embed",
        "norm.weight": "norm.weight",
    }
    for ours_key, ref_key in same.items():
        np.testing.assert_array_equal(state[ours_key].numpy(), sd[ref_key], err_msg=ours_key)


def test_matcher_checkpoint_round_trip():
    """The released matcher layout ('matcher.'-prefixed LoFTR keys) -> the
    copied converter (equal to pope_tpu's) -> the bridge: loads strictly into
    the full MatcherConfig(), BatchNorm statistics land in running_mean /
    running_var, Linear and conv weights equal the file's."""
    sd = _manifest_checkpoint("matcher", 3)
    ours = convert_torch_matcher_state(sd)
    ref = jax_convert_matcher(sd)
    for coll in ("params", "batch_stats"):
        mine, theirs = dict(_flatten(ours[coll])), dict(_flatten(ref[coll]))
        assert mine.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg="/".join(k))
    model = Matcher(MatcherConfig())
    model.load_state_dict(matcher_state_from_jax(ours), strict=True)
    state = model.state_dict()
    same = {
        "backbone.stem_conv.weight": "backbone.conv1.weight",
        "backbone.stem_bn.running_mean": "backbone.bn1.running_mean",
        "backbone.stem_bn.running_var": "backbone.bn1.running_var",
        "backbone.layer2_0.down.conv.weight": "backbone.layer2.0.downsample.0.weight",
        "backbone.layer3_1.cb2.bn.running_var": "backbone.layer3.1.bn2.running_var",
        "backbone.layer3_1.cb2.bn.weight": "backbone.layer3.1.bn2.weight",
        "backbone.l1_out.conv_out.weight": "backbone.layer1_outconv2.3.weight",
        "loftr_coarse.layer_7.mlp1.weight": "loftr_coarse.layers.7.mlp.0.weight",
        "loftr_fine.layer_1.merge.weight": "loftr_fine.layers.1.merge.weight",
        "fine_merge_feat.weight": "fine_preprocess.merge_feat.weight",
    }
    for ours_key, ref_key in same.items():
        np.testing.assert_array_equal(state[ours_key].numpy(), sd["matcher." + ref_key], err_msg=ours_key)


def test_bridge_keeps_scalars_and_maps_batch_stats():
    """A scalar leaf (the sinkhorn variant's bin_score) stays a 0-dim tensor;
    BatchNorm `mean` / `var` become running_mean / running_var; flax `scale`
    becomes `weight`."""
    out = params_state_from_jax({
        "params": {"bin_score": np.float32(1.5), "bn": {"scale": np.ones(3), "bias": np.zeros(3)}},
        "batch_stats": {"bn": {"mean": np.full(3, 0.25), "var": np.full(3, 2.0)}},
    })
    assert out["bin_score"].shape == () and float(out["bin_score"]) == 1.5
    assert sorted(out) == ["bin_score", "bn.bias", "bn.running_mean", "bn.running_var", "bn.weight"]
    assert out["bn.running_var"].dtype == torch.float32 and float(out["bn.running_mean"][0]) == 0.25


def _to_jax_tree(state):
    """Test-side inverse of the bridge: port state_dict -> flax-layout tree."""
    tree = {}
    for key, t in state.items():
        *mod, name = key.split(".")
        a = t.float().numpy()
        if name == "weight" and a.ndim == 2:
            name, a = "kernel", a.T
        elif name == "weight" and a.ndim == 4:
            name, a = "kernel", a.transpose(2, 3, 1, 0)
        elif name == "weight" and not mod[-1].startswith(("up_ln", "neck_ln")):
            name = "scale"
        node = tree
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = a
    return tree


def test_bridge_round_trip():
    cfg = tiny_cfg(False)
    params = jax_params(cfg, seed=5)
    sam = port_sam(cfg, params)
    back = dict(_flatten(_to_jax_tree(sam.state_dict())))
    ref = dict(_flatten(params["params"]))
    assert set(ref) <= set(back)
    # the mask-input convs, which the JAX init does not create
    assert all(k[0] == "prompt_encoder" and k[1].startswith("mask_") for k in set(back) - set(ref))
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg="/".join(k))


def test_config_copy_matches_jax_config():
    """The port's config.py holds pope_tpu/config.py's dataclasses field for
    field, with the same defaults and SAM size presets."""
    import pope_tpu.config as jcfg
    import pope_tpu_torch.config as tcfg

    def classes(mod):
        return [n for n, c in vars(mod).items() if isinstance(c, type) and dataclasses.is_dataclass(c)]

    assert classes(tcfg) == classes(jcfg)
    for name in classes(jcfg):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)()), name
    for size in ("vit_b", "vit_l", "vit_h"):
        ours, ref = getattr(tcfg.SamEncoderConfig, size)(), getattr(jcfg.SamEncoderConfig, size)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), size


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_models(sam_type="b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_models(components=("dinov2", "matcher"))
    with pytest.raises(ValueError, match="unknown components"):
        load_models(components=("sam", "regressor"), device="cpu")


def test_load_models_on_cpu_with_seeded_weights(monkeypatch):
    """Seeded random init is reproducible, fills the rel-pos tables and pos
    embed with non-zero values, and stores the bf16 encoder in bf16. (ViT-B's
    encoder factory is swapped for a tiny one: load_models takes the encoder
    from sam_type.)"""
    from pope_tpu_torch.pipeline import api

    enc = SamEncoderConfig(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,), out_chans=32)
    monkeypatch.setitem(api.SAM_CHECKPOINTS, "b", (api.SAM_CHECKPOINTS["b"][0], lambda: enc))
    cfg = dataclasses.replace(
        PipelineConfig(),
        sam=dataclasses.replace(SamConfig(), prompt_embed_dim=32, decoder_mlp_dim=64, iou_head_hidden_dim=32),
    )
    m = load_models(cfg, sam_type="b", seed=3, device="cpu")
    assert m.device == torch.device("cpu") and m.amg.device == torch.device("cpu")
    enc_mod = m.sam.image_encoder
    assert enc_mod.block_0.qkv.weight.dtype == torch.bfloat16
    assert enc_mod.block_0.norm1.weight.dtype == torch.float32
    assert enc_mod.block_1.rel_pos_h.abs().min() > 0 and enc_mod.pos_embed.abs().sum() > 0
    # DINOv2's LayerScale is drawn O(0.1-1), not its 1e-5 init, so the
    # attention blocks move the residual stream
    gammas = torch.cat([blk.ls1.gamma for blk in (m.dinov2.block_0, m.dinov2.block_11)])
    assert gammas.min() >= 0.1 and gammas.max() <= 1.0
    assert m.matcher.backbone.stem_conv.weight.abs().sum() > 0
    again = load_models(cfg, sam_type="b", seed=3, device="cpu")
    for tower in ("sam", "dinov2", "matcher"):
        mine, theirs = getattr(m, tower).state_dict(), getattr(again, tower).state_dict()
        for (k, a), (_, b) in zip(mine.items(), theirs.items()):
            assert torch.equal(a, b), f"{tower}.{k}"


def test_port_imports_no_jax_and_calls_no_library_attention():
    """chip_smoke.py may time SDPA as a yardstick; the package never calls it."""
    package = sorted((ROOT / "pope_tpu_torch").rglob("*.py"))
    banned_import = re.compile(r"^\s*(import|from)\s+(jax|flax|pope_tpu)(\.|\s|$)", re.M)
    for f in package + [ROOT / "chip_smoke.py"]:
        assert not banned_import.search(f.read_text()), f
    for f in package:
        text = f.read_text()
        assert "scaled_dot_product_attention" not in text and "torch.compile" not in text, f
    for f in (ROOT / "pope_tpu_torch" / "csrc").iterdir():
        assert "cudnn" not in f.read_text().lower(), f
