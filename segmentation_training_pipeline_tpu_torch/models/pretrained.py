"""Pretrained encoder weights: readers of torch, Keras ``.h5`` and ``.npz``
files into the port's encoders.

Counterpart of ``segmentation_training_pipeline_tpu/models/pretrained.py``
(a copy: the port imports nothing of that package).  ``encoder_weights``
is the upstream pipeline's main accuracy lever; a config names it as

  * ``encoder_weights: /path/to/resnet34.pt`` — a torchvision-style state
    dict (``conv1/bn1/layer{1..4}.{b}.conv{1..3}/bn{1..3}/downsample.{0,1}``
    and the other families' published naming), read with
    ``torch.load(..., weights_only=True)``;
  * ``encoder_weights: /path/to/enc.npz`` — a flat ``{'/'.join(path):
    array}`` dump of the encoder tree (:func:`export_encoder_npz`);
  * ``encoder_weights: /path/to/resnet34.h5`` — a Keras file
    (``keras_h5.py``);
  * ``encoder_weights: imagenet`` (or ``imagenet21k``/``pascal_voc``) —
    looked up under ``$STP_PRETRAINED_DIR`` (default
    ``~/.cache/stp_pretrained``) as ``{backbone}.pt``/``.pth``/``.h5``/
    ``.npz``; a warning, not an error, when absent (training goes on from
    scratch), unless ``STP_REQUIRE_PRETRAINED`` is set.

The converters work on the encoder's variables in the tree layout of
``models.bridge`` (``{"params": …, "batch_stats": …}``, HWIO kernels,
numpy leaves), so each one is the reference's line for line and writes the
same values bit for bit; :func:`load_into_model` moves a model's state dict
into that layout and back.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import bridge


# ``encoder_weights`` names looked up under $STP_PRETRAINED_DIR, and the
# file extensions tried for each, in order
NAMED_SPECS = ("imagenet", "imagenet21k", "pascal_voc")
NAMED_EXTENSIONS = (".pt", ".pth", ".h5", ".npz")


class PretrainedWeightsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# torchvision-resnet naming → our ResNetEncoder tree
# ---------------------------------------------------------------------------

def _torch_conv(w) -> np.ndarray:
    # torch OIHW → HWIO
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def convert_torch_resnet(state: Dict[str, Any],
                         params_enc: Dict[str, Any],
                         stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Return (new encoder params, new encoder batch_stats) with values from
    a torchvision-style resnet state dict.  Shapes are validated against the
    target tree; any mismatch raises with the offending key.

    Also covers the wider resnet family:

    * **resnext50/101** — torchvision ``resnext*_32x4d`` uses the exact same
      key naming; grouped-conv kernels are ``(O, I/g, kH, kW)`` and the same
      OIHW→HWIO transpose lands them in the grouped HWIO layout.
    * **seresnet/seresnext** — Cadene/pretrainedmodels ``senet.py`` naming
      (the origin of every SE checkpoint in the wild, and of timm's
      ``legacy_seresnet*``): an optional ``layer0.`` stem prefix is stripped,
      and per-block SE weights are read from ``…​.se_module.fc{1,2}`` (or
      timm-modern ``…​.se.fc{1,2}``), accepting both conv-1x1 (4-D) and
      Linear (2-D) parameterizations.  Loading plain-resnet weights into an
      SE encoder (or vice versa) raises instead of silently leaving the SE
      (or dropping its) weights.
    """

    # Cadene senet stems live under layer0.* (conv1/bn1) — normalize.
    if "conv1.weight" not in state and "layer0.conv1.weight" in state:
        state = {(k[len("layer0."):] if k.startswith("layer0.") else k): v
                 for k, v in state.items()}

    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    def put_conv(dst: Dict[str, Any], key: str):
        """dst: the conv param subtree (holds 'kernel'); validates shape."""
        w = _torch_conv(state[key])
        tgt = dst["kernel"]
        if tuple(tgt.shape) != w.shape:
            raise PretrainedWeightsError(
                f"{key}: shape {w.shape} != target {tuple(tgt.shape)}")
        dst["kernel"] = w.astype(tgt.dtype)

    def put_bn(dst_p: Dict[str, Any], dst_s: Dict[str, Any], prefix: str):
        """dst_p/dst_s: the BN param/stats subtrees; validates shapes."""
        pairs = [("weight", dst_p, "scale"), ("bias", dst_p, "bias"),
                 ("running_mean", dst_s, "mean"),
                 ("running_var", dst_s, "var")]
        for tkey, tree, fkey in pairs:
            v = np.asarray(state[f"{prefix}.{tkey}"])
            tgt = tree[fkey]
            if tuple(tgt.shape) != v.shape:
                raise PretrainedWeightsError(
                    f"{prefix}.{tkey}: shape {v.shape} != {tuple(tgt.shape)}")
            tree[fkey] = v.astype(tgt.dtype)

    def put_se(se_p: Dict[str, Any], prefix: str):
        for src, dst in (("fc1", "reduce"), ("fc2", "expand")):
            w = np.asarray(state[f"{prefix}.{src}.weight"])
            if w.ndim == 2:  # nn.Linear SE variant: (O, I) → (O, I, 1, 1)
                w = w[:, :, None, None]
            w = np.transpose(w, (2, 3, 1, 0))
            tgt = se_p[dst]["kernel"]
            if tuple(tgt.shape) != w.shape:
                raise PretrainedWeightsError(
                    f"{prefix}.{src}.weight: shape {w.shape} != "
                    f"{tuple(tgt.shape)}")
            se_p[dst]["kernel"] = w.astype(tgt.dtype)
            b = np.asarray(state[f"{prefix}.{src}.bias"])
            se_p[dst]["bias"] = b.astype(se_p[dst]["bias"].dtype)

    # stem: classic 7x7 single conv, or senet154's deep 3-conv stem
    if "stem_conv3" in params:
        if "conv3.weight" not in state:
            raise PretrainedWeightsError(
                "encoder has senet154's deep 3-conv stem but the state "
                "dict has a single-conv stem (wrong backbone?)")
        for i in (1, 2, 3):
            put_conv(params[f"stem_conv{i}"], f"conv{i}.weight")
            put_bn(params[f"stem_bn{i}"], stats[f"stem_bn{i}"], f"bn{i}")
    else:
        put_conv(params["stem_conv"], "conv1.weight")
        put_bn(params["stem_bn"], stats["stem_bn"], "bn1")

    # stages
    for stage in range(1, 5):
        b = 0
        while f"layer{stage}.{b}.conv1.weight" in state:
            mod = f"stage{stage}_block{b + 1}"
            if mod not in params:
                raise PretrainedWeightsError(
                    f"state dict has layer{stage}.{b} but encoder has no {mod}"
                    " — depth mismatch (wrong backbone?)")
            blk_p, blk_s = params[mod], stats[mod]
            n_convs = 3 if "conv3" in blk_p else 2
            for ci in range(1, n_convs + 1):
                put_conv(blk_p[f"conv{ci}"],
                         f"layer{stage}.{b}.conv{ci}.weight")
                put_bn(blk_p[f"bn{ci}"], blk_s[f"bn{ci}"],
                       f"layer{stage}.{b}.bn{ci}")
            if f"layer{stage}.{b}.downsample.0.weight" in state:
                put_conv(blk_p["downsample"],
                         f"layer{stage}.{b}.downsample.0.weight")
                put_bn(blk_p["bn_down"], blk_s["bn_down"],
                       f"layer{stage}.{b}.downsample.1")
            se_src = next(
                (p for p in (f"layer{stage}.{b}.se_module",
                             f"layer{stage}.{b}.se")
                 if f"{p}.fc1.weight" in state), None)
            if "se" in blk_p:
                if se_src is None:
                    raise PretrainedWeightsError(
                        f"encoder block {mod} has an SE module but the state "
                        f"dict has no layer{stage}.{b}.se_module/.se weights "
                        "— plain-resnet weights into an SE-ResNet would "
                        "leave SE at random init (wrong backbone?)")
                put_se(blk_p["se"], se_src)
            elif se_src is not None:
                raise PretrainedWeightsError(
                    f"state dict carries SE weights at {se_src} but the "
                    "encoder is a plain resnet — they would be silently "
                    "dropped (use the seresnet/seresnext backbone?)")
            b += 1
        if b == 0:
            raise PretrainedWeightsError(
                f"state dict has no layer{stage} blocks — not a resnet?")
    return params, stats


def tree_copy(tree):
    """Nested dicts of arrays → new nested dicts of numpy copies (the
    converters write into the copy; the caller's tree stays as it was)."""
    return {k: tree_copy(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# shared put-helpers for torch-format converters
# ---------------------------------------------------------------------------

def _put_conv(state, dst: Dict[str, Any], key: str,
              bias_key: Optional[str] = None):
    w = _torch_conv(state[key])
    tgt = dst["kernel"]
    if tuple(tgt.shape) != w.shape:
        raise PretrainedWeightsError(
            f"{key}: shape {w.shape} != target {tuple(tgt.shape)}")
    dst["kernel"] = w.astype(tgt.dtype)
    if bias_key is not None:
        b = np.asarray(state[bias_key])
        if tuple(dst["bias"].shape) != b.shape:
            raise PretrainedWeightsError(
                f"{bias_key}: shape {b.shape} != {tuple(dst['bias'].shape)}")
        dst["bias"] = b.astype(dst["bias"].dtype)


def _put_bn(state, dst_p: Dict[str, Any], dst_s: Dict[str, Any], prefix: str):
    pairs = [("weight", dst_p, "scale"), ("bias", dst_p, "bias"),
             ("running_mean", dst_s, "mean"), ("running_var", dst_s, "var")]
    for tkey, tree, fkey in pairs:
        v = np.asarray(state[f"{prefix}.{tkey}"])
        tgt = tree[fkey]
        if tuple(tgt.shape) != v.shape:
            raise PretrainedWeightsError(
                f"{prefix}.{tkey}: shape {v.shape} != {tuple(tgt.shape)}")
        tree[fkey] = v.astype(tgt.dtype)


# ---------------------------------------------------------------------------
# torchvision-efficientnet naming → our EfficientNetEncoder tree
# (torchvision `efficientnet_b{0..7}` state dicts: `features.0` stem,
#  `features.{1..7}.{i}.block.*` MBConv stages, `features.8` head.)
# Deviation note: torchvision pads stride-2 convs symmetrically while this
# encoder pads SAME — a sub-pixel spatial offset, weights convert exactly.
# ---------------------------------------------------------------------------

def convert_torch_efficientnet(state: Dict[str, Any],
                               params_enc: Dict[str, Any],
                               stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_conv(state, params["stem_conv"], "features.0.0.weight")
    _put_bn(state, params["stem_bn"], stats["stem_bn"], "features.0.1")

    for si in range(7):
        i = 0
        while f"stage{si}_block{i}" in params:
            mod = f"stage{si}_block{i}"
            blk_p, blk_s = params[mod], stats[mod]
            p = f"features.{si + 1}.{i}.block"
            if f"{p}.0.0.weight" not in state:
                raise PretrainedWeightsError(
                    f"state dict missing {p} — depth mismatch "
                    "(wrong efficientnet variant?)")
            has_expand = "expand" in blk_p
            off = 0
            if has_expand:
                _put_conv(state, blk_p["expand"], f"{p}.0.0.weight")
                _put_bn(state, blk_p["expand_bn"], blk_s["expand_bn"],
                        f"{p}.0.1")
                off = 1
            _put_conv(state, blk_p["depthwise"], f"{p}.{off}.0.weight")
            _put_bn(state, blk_p["dw_bn"], blk_s["dw_bn"], f"{p}.{off}.1")
            se = blk_p["se"]
            _put_conv(state, se["reduce"], f"{p}.{off + 1}.fc1.weight",
                      f"{p}.{off + 1}.fc1.bias")
            _put_conv(state, se["expand"], f"{p}.{off + 1}.fc2.weight",
                      f"{p}.{off + 1}.fc2.bias")
            _put_conv(state, blk_p["project"], f"{p}.{off + 2}.0.weight")
            _put_bn(state, blk_p["project_bn"], blk_s["project_bn"],
                    f"{p}.{off + 2}.1")
            i += 1
        if i == 0:
            raise PretrainedWeightsError(
                f"encoder has no stage{si} blocks — not an efficientnet?")
    _put_conv(state, params["head_conv"], "features.8.0.weight")
    _put_bn(state, params["head_bn"], stats["head_bn"], "features.8.1")
    return params, stats


# ---------------------------------------------------------------------------
# torchvision-mobilenet_v2 naming → our MobileNetV2Encoder tree
# (`features.0` stem, `features.{1..17}.conv.*` inverted residuals,
#  `features.18` head.)
# ---------------------------------------------------------------------------

def convert_torch_mobilenetv2(state: Dict[str, Any],
                              params_enc: Dict[str, Any],
                              stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_conv(state, params["stem_conv"], "features.0.0.weight")
    _put_bn(state, params["stem_bn"], stats["stem_bn"], "features.0.1")

    bi = 0
    while f"block{bi}" in params:
        mod = f"block{bi}"
        blk_p, blk_s = params[mod], stats[mod]
        p = f"features.{bi + 1}.conv"
        if f"{p}.0.0.weight" not in state:
            raise PretrainedWeightsError(
                f"state dict missing {p} — depth mismatch (not mobilenet_v2?)")
        if "expand" in blk_p:
            _put_conv(state, blk_p["expand"], f"{p}.0.0.weight")
            _put_bn(state, blk_p["expand_bn"], blk_s["expand_bn"], f"{p}.0.1")
            _put_conv(state, blk_p["depthwise"], f"{p}.1.0.weight")
            _put_bn(state, blk_p["dw_bn"], blk_s["dw_bn"], f"{p}.1.1")
            _put_conv(state, blk_p["project"], f"{p}.2.weight")
            _put_bn(state, blk_p["project_bn"], blk_s["project_bn"], f"{p}.3")
        else:  # expansion-1 first block: depthwise / project only
            _put_conv(state, blk_p["depthwise"], f"{p}.0.0.weight")
            _put_bn(state, blk_p["dw_bn"], blk_s["dw_bn"], f"{p}.0.1")
            _put_conv(state, blk_p["project"], f"{p}.1.weight")
            _put_bn(state, blk_p["project_bn"], blk_s["project_bn"], f"{p}.2")
        bi += 1
    if bi == 0:
        raise PretrainedWeightsError("encoder has no block0 — not mobilenetv2?")
    _put_conv(state, params["head_conv"], "features.18.0.weight")
    _put_bn(state, params["head_bn"], stats["head_bn"], "features.18.1")
    return params, stats


# ---------------------------------------------------------------------------
# timm-mobilenetv1 naming → our MobileNetV1Encoder tree
# (`conv_stem` + `bn1` stem; `blocks.{s}.{j}` DepthwiseSeparableConv units
#  with `conv_dw`/`bn1`/`conv_pw`/`bn2` — timm `mobilenetv1_100`.  There is
#  no torchvision mobilenet v1; timm's is the canonical torch checkpoint
#  lineage.  Stage grouping r1/r2/r2/r6/r2 flattens to our 13 blocks.)
# ---------------------------------------------------------------------------

def convert_torch_mobilenetv1(state: Dict[str, Any],
                              params_enc: Dict[str, Any],
                              stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    if "conv_stem.weight" not in state:
        raise PretrainedWeightsError(
            "state dict has no conv_stem — not a timm mobilenetv1? "
            "(mobilenet_v2 checkpoints use the mobilenetv2 backbone)")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_conv(state, params["conv1"], "conv_stem.weight")
    _put_bn(state, params["conv1_bn"], stats["conv1_bn"], "bn1")

    # flatten timm's (stage, repeat) grouping into keras' 1..13 numbering
    flat = []
    s = 0
    while f"blocks.{s}.0.conv_dw.weight" in state:
        j = 0
        while f"blocks.{s}.{j}.conv_dw.weight" in state:
            flat.append(f"blocks.{s}.{j}")
            j += 1
        s += 1
    if len(flat) != 13:
        raise PretrainedWeightsError(
            f"state dict has {len(flat)} depthwise-separable blocks; "
            "mobilenet v1 has 13 — wrong model?")
    for i, p in enumerate(flat, start=1):
        # timm stores depthwise kernels as (C, 1, kH, kW); the OIHW→HWIO
        # transpose yields (kH, kW, 1, C) — exactly the grouped HWIO layout
        _put_conv(state, params[f"conv_dw_{i}"], f"{p}.conv_dw.weight")
        _put_bn(state, params[f"conv_dw_{i}_bn"], stats[f"conv_dw_{i}_bn"],
                f"{p}.bn1")
        _put_conv(state, params[f"conv_pw_{i}"], f"{p}.conv_pw.weight")
        _put_bn(state, params[f"conv_pw_{i}_bn"], stats[f"conv_pw_{i}_bn"],
                f"{p}.bn2")
    return params, stats


# ---------------------------------------------------------------------------
# npz round-trip of our own encoder tree
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def export_encoder_npz(path: str, variables: Dict[str, Any]) -> None:
    flat = {}
    flat.update({f"params/{k}": v for k, v in
                 _flatten(variables["params"]["encoder"]).items()})
    flat.update({f"batch_stats/{k}": v for k, v in
                 _flatten(variables.get("batch_stats", {}).get("encoder", {})
                          ).items()})
    np.savez(path, **flat)


def _load_npz_into(path: str, params_enc, stats_enc):
    data = np.load(path)
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    def apply(node, prefix):
        for k in list(node.keys()):
            key = f"{prefix}/{k}"
            if isinstance(node[k], dict):
                apply(node[k], key)
            else:
                if key not in data:
                    raise PretrainedWeightsError(f"npz missing {key}")
                v = data[key]
                if v.shape != node[k].shape:
                    raise PretrainedWeightsError(
                        f"{key}: {v.shape} != {node[k].shape}")
                node[k] = v.astype(node[k].dtype)

    apply(params, "params")
    if stats:
        apply(stats, "batch_stats")
    return params, stats


# ---------------------------------------------------------------------------
# torchvision-densenet naming → our DenseNetEncoder tree
# (`features.conv0/norm0`, `features.denseblock{b}.denselayer{l}.
#  norm1/conv1/norm2/conv2`, `features.transition{b}.norm/conv`,
#  `features.norm5` — a direct 1:1 mapping.)
# ---------------------------------------------------------------------------

def convert_torch_densenet(state: Dict[str, Any],
                           params_enc: Dict[str, Any],
                           stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    # the canonical downloadable torchvision .pth files use LEGACY dotted
    # layer names (denselayer1.norm.1.weight); torchvision renames them on
    # load with exactly this regex — accept both spellings
    pat = re.compile(
        r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|"
        r"running_mean|running_var))$")
    state = {
        (pat.sub(lambda m: m.group(1) + m.group(2), k)
         if pat.match(k) else k): v
        for k, v in state.items()
    }
    new_p = tree_copy(params_enc)
    new_s = tree_copy(stats_enc)

    _put_conv(state, new_p["stem_conv"], "features.conv0.weight")
    _put_bn(state, new_p["stem_bn"], new_s["stem_bn"], "features.norm0")

    for b in range(1, 5):
        li = 1
        while f"block{b}_layer{li}" in new_p:
            src = f"features.denseblock{b}.denselayer{li}"
            if f"{src}.conv1.weight" not in state:
                raise PretrainedWeightsError(
                    f"state dict missing {src} — depth mismatch (wrong "
                    "densenet variant?)")
            blk_p = new_p[f"block{b}_layer{li}"]
            blk_s = new_s[f"block{b}_layer{li}"]
            _put_bn(state, blk_p["bn1"], blk_s["bn1"], f"{src}.norm1")
            _put_conv(state, blk_p["conv1"], f"{src}.conv1.weight")
            _put_bn(state, blk_p["bn2"], blk_s["bn2"], f"{src}.norm2")
            _put_conv(state, blk_p["conv2"], f"{src}.conv2.weight")
            li += 1
        if li == 1:
            raise PretrainedWeightsError(
                f"encoder has no block{b} layers — not a densenet?")
        if f"features.denseblock{b}.denselayer{li}.conv1.weight" in state:
            raise PretrainedWeightsError(
                f"state dict has denseblock{b}.denselayer{li} beyond the "
                "encoder's depth — wrong densenet variant?")
        if b < 4:
            _put_bn(state, new_p[f"trans{b}_bn"], new_s[f"trans{b}_bn"],
                    f"features.transition{b}.norm")
            _put_conv(state, new_p[f"trans{b}_conv"],
                      f"features.transition{b}.conv.weight")
    _put_bn(state, new_p["final_bn"], new_s["final_bn"], "features.norm5")
    return new_p, new_s


# ---------------------------------------------------------------------------
# torchvision-vgg naming → our VGGEncoder tree
# (torchvision `vgg16`/`vgg16_bn`/`vgg19(_bn)` state dicts: a flat
#  `features.{i}.*` Sequential — convs and BNs are matched POSITIONALLY to
#  the encoder's stage{s}_conv{c}/stage{s}_bn{c} layout, which is robust
#  to the index gaps maxpool/relu entries introduce.)
# ---------------------------------------------------------------------------

def convert_torch_vgg(state: Dict[str, Any],
                      params_enc: Dict[str, Any],
                      stats_enc: Dict[str, Any]):
    """Fill VGGEncoder params/batch_stats from a torchvision-style vgg
    state dict.  Plain (norm-free) vgg fills convs only — the encoder's
    BN layers keep their init (identity scale, unit var); _bn variants
    fill BN parameters and running stats too."""
    new_p = tree_copy(params_enc)
    new_s = tree_copy(stats_enc)

    idx_of = {}
    for key in state:
        m = re.match(r"features\.(\d+)\.weight$", key)
        if m:
            idx_of[int(m.group(1))] = key
    conv_idx = sorted(i for i in idx_of
                      if np.asarray(state[idx_of[i]]).ndim == 4)
    bn_idx = sorted(i for i in idx_of
                    if np.asarray(state[idx_of[i]]).ndim == 1
                    and f"features.{i}.running_mean" in state)
    if not conv_idx:
        raise PretrainedWeightsError(
            "state dict has no features.N conv tensors — not a vgg?")

    targets = []  # (conv_name, bn_name) in encoder order
    stage = 1
    while f"stage{stage}_conv1" in new_p:
        c = 1
        while f"stage{stage}_conv{c}" in new_p:
            targets.append((f"stage{stage}_conv{c}", f"stage{stage}_bn{c}"))
            c += 1
        stage += 1
    if len(conv_idx) != len(targets):
        raise PretrainedWeightsError(
            f"vgg depth mismatch: state dict has {len(conv_idx)} convs, "
            f"encoder expects {len(targets)} (wrong vgg16/vgg19 variant?)")
    if bn_idx and len(bn_idx) != len(targets):
        raise PretrainedWeightsError(
            f"vgg BN count mismatch: {len(bn_idx)} vs {len(targets)}")

    for ti, (conv_name, bn_name) in enumerate(targets):
        ck = idx_of[conv_idx[ti]]
        bias_key = ck[:-len("weight")] + "bias"
        _put_conv(state, new_p[conv_name], ck,
                  bias_key if "bias" in new_p[conv_name]
                  and bias_key in state else None)
        if bn_idx and bn_name in new_p:
            _put_bn(state, new_p[bn_name], new_s[bn_name],
                    f"features.{bn_idx[ti]}")
        if bias_key in state and "bias" not in new_p[conv_name]:
            # The encoder's conv is bias-less (BN follows), but torchvision
            # vgg convs carry a bias in BOTH variants (vgg16_bn's BN stats
            # were computed on Wx+b).  Fold it into the BN running mean:
            # (x + b − mean)·γ/σ + β == (x − (mean − b))·γ/σ + β exactly.
            b = np.asarray(state[bias_key])
            tgt = new_s[bn_name]["mean"]
            if tuple(tgt.shape) != b.shape:
                raise PretrainedWeightsError(
                    f"{bias_key}: shape {b.shape} != {tuple(tgt.shape)}")
            new_s[bn_name]["mean"] = (
                np.asarray(new_s[bn_name]["mean"]) - b).astype(tgt.dtype)
    return new_p, new_s


# ---------------------------------------------------------------------------
# torchvision inception_v3 naming → our InceptionV3Encoder tree
# ---------------------------------------------------------------------------

def _put_cbr(state, dst_p: Dict[str, Any], dst_s: Dict[str, Any],
             prefix: str):
    """One BasicConv2d (``{prefix}.conv.weight`` + ``{prefix}.bn.*``) into a
    _CBR subtree (``conv``/``bn``)."""
    _put_conv(state, dst_p["conv"], f"{prefix}.conv.weight")
    _put_bn(state, dst_p["bn"], dst_s["bn"], f"{prefix}.bn")


# encoder submodule → torchvision branch name, per inception-v3 block family
_INC3_A = {"b1x1": "branch1x1", "b5_1": "branch5x5_1", "b5_2": "branch5x5_2",
           "b3_1": "branch3x3dbl_1", "b3_2": "branch3x3dbl_2",
           "b3_3": "branch3x3dbl_3", "bp": "branch_pool"}
_INC3_RA = {"b3": "branch3x3", "bd_1": "branch3x3dbl_1",
            "bd_2": "branch3x3dbl_2", "bd_3": "branch3x3dbl_3"}
_INC3_B = {"b1x1": "branch1x1", "b7_1": "branch7x7_1", "b7_2": "branch7x7_2",
           "b7_3": "branch7x7_3", "bd_1": "branch7x7dbl_1",
           "bd_2": "branch7x7dbl_2", "bd_3": "branch7x7dbl_3",
           "bd_4": "branch7x7dbl_4", "bd_5": "branch7x7dbl_5",
           "bp": "branch_pool"}
_INC3_RB = {"b3_1": "branch3x3_1", "b3_2": "branch3x3_2",
            "b7_1": "branch7x7x3_1", "b7_2": "branch7x7x3_2",
            "b7_3": "branch7x7x3_3", "b7_4": "branch7x7x3_4"}
_INC3_C = {"b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a",
           "b3_2b": "branch3x3_2b", "bd_1": "branch3x3dbl_1",
           "bd_2": "branch3x3dbl_2", "bd_3a": "branch3x3dbl_3a",
           "bd_3b": "branch3x3dbl_3b", "bp": "branch_pool"}


def convert_torch_inceptionv3(state: Dict[str, Any],
                              params_enc: Dict[str, Any],
                              stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """torchvision ``inception_v3`` state dict → InceptionV3Encoder tree.

    Block map (torchvision module → encoder module): ``Conv2d_{1a,2a,2b,3b,4a}``
    → ``stem1..5``; ``Mixed_5{b,c,d}`` → ``mixed0..2`` (InceptionA);
    ``Mixed_6a`` → ``mixed3``; ``Mixed_6{b..e}`` → ``mixed4..7``;
    ``Mixed_7a`` → ``mixed8``; ``Mixed_7{b,c}`` → ``mixed9..10``.
    ``AuxLogits``/``fc`` are dropped (classification heads).
    """
    if "Conv2d_1a_3x3.conv.weight" not in state:
        raise PretrainedWeightsError(
            "state dict has no Conv2d_1a_3x3 — not a torchvision "
            "inception_v3?")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    stems = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
             "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
    for i, tmod in enumerate(stems):
        _put_cbr(state, params[f"stem{i + 1}"], stats[f"stem{i + 1}"], tmod)

    blocks = ([(f"mixed{i}", f"Mixed_5{s}", _INC3_A)
               for i, s in enumerate("bcd")] +
              [("mixed3", "Mixed_6a", _INC3_RA)] +
              [(f"mixed{4 + i}", f"Mixed_6{s}", _INC3_B)
               for i, s in enumerate("bcde")] +
              [("mixed8", "Mixed_7a", _INC3_RB)] +
              [(f"mixed{9 + i}", f"Mixed_7{s}", _INC3_C)
               for i, s in enumerate("bc")])
    for fmod, tmod, submap in blocks:
        for fsub, tsub in submap.items():
            _put_cbr(state, params[fmod][fsub], stats[fmod][fsub],
                     f"{tmod}.{tsub}")
    return params, stats


# ---------------------------------------------------------------------------
# timm inception_resnet_v2 naming → our InceptionResNetV2Encoder tree
# ---------------------------------------------------------------------------

def convert_torch_inceptionresnetv2(state: Dict[str, Any],
                                    params_enc: Dict[str, Any],
                                    stats_enc: Dict[str, Any],
                                    ) -> Tuple[Dict, Dict]:
    """timm/Cadene ``inception_resnet_v2`` state dict →
    InceptionResNetV2Encoder tree.

    Naming facts encoded: stem ``conv2d_{1a,2a,2b,3b,4a}``; ``mixed_5b``
    branches 0/1/2 are BasicConv2d chains and ``branch3.1`` the pool-branch
    conv (``branch3.0`` is the parameter-free avg-pool); ``repeat.{i}`` =
    10× Block35, ``repeat_1.{i}`` = 20× Block17, ``repeat_2.{i}`` =
    9× Block8, plus the final no-ReLU ``block8`` (scale 1.0) and
    ``conv2d_7b``.  Each residual block's ``conv2d`` (with bias) lands in
    our ``up`` conv.  ``classif``/``last_linear`` are dropped.
    """
    if "conv2d_1a.conv.weight" not in state:
        raise PretrainedWeightsError(
            "state dict has no conv2d_1a — not a timm inception_resnet_v2?")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    for i, tmod in enumerate(["conv2d_1a", "conv2d_2a", "conv2d_2b",
                              "conv2d_3b", "conv2d_4a"]):
        _put_cbr(state, params[f"stem{i + 1}"], stats[f"stem{i + 1}"], tmod)

    m5b = {"m5b_b0": "branch0", "m5b_b1_1": "branch1.0",
           "m5b_b1_2": "branch1.1", "m5b_b2_1": "branch2.0",
           "m5b_b2_2": "branch2.1", "m5b_b2_3": "branch2.2",
           "m5b_bp": "branch3.1"}
    for fsub, tsub in m5b.items():
        _put_cbr(state, params[fsub], stats[fsub], f"mixed_5b.{tsub}")

    def put_irblock(fmod: str, tprefix: str, branch_map: Dict[str, str]):
        for fsub, tsub in branch_map.items():
            _put_cbr(state, params[fmod][fsub], stats[fmod][fsub],
                     f"{tprefix}.{tsub}")
        _put_conv(state, params[fmod]["up"], f"{tprefix}.conv2d.weight",
                  f"{tprefix}.conv2d.bias")

    b35 = {"b0": "branch0", "b1_1": "branch1.0", "b1_2": "branch1.1",
           "b2_1": "branch2.0", "b2_2": "branch2.1", "b2_3": "branch2.2"}
    b17 = {"b0": "branch0", "b1_1": "branch1.0", "b1_2": "branch1.1",
           "b1_3": "branch1.2"}
    b8 = {"b0": "branch0", "b1_1": "branch1.0", "b1_2": "branch1.1",
          "b1_3": "branch1.2"}
    for i in range(10):
        put_irblock(f"block35_{i + 1}", f"repeat.{i}", b35)
    m6a = {"m6a_b0": "branch0", "m6a_b1_1": "branch1.0",
           "m6a_b1_2": "branch1.1", "m6a_b1_3": "branch1.2"}
    for fsub, tsub in m6a.items():
        _put_cbr(state, params[fsub], stats[fsub], f"mixed_6a.{tsub}")
    for i in range(20):
        put_irblock(f"block17_{i + 1}", f"repeat_1.{i}", b17)
    m7a = {"m7a_b0_1": "branch0.0", "m7a_b0_2": "branch0.1",
           "m7a_b1_1": "branch1.0", "m7a_b1_2": "branch1.1",
           "m7a_b2_1": "branch2.0", "m7a_b2_2": "branch2.1",
           "m7a_b2_3": "branch2.2"}
    for fsub, tsub in m7a.items():
        _put_cbr(state, params[fsub], stats[fsub], f"mixed_7a.{tsub}")
    for i in range(9):
        put_irblock(f"block8_{i + 1}", f"repeat_2.{i}", b8)
    put_irblock("block8_10", "block8", b8)
    _put_cbr(state, params["conv7b"], stats["conv7b"], "conv2d_7b")
    return params, stats


# ---------------------------------------------------------------------------
# Cadene/timm legacy xception naming → our XceptionEncoder tree
# ---------------------------------------------------------------------------

def convert_torch_xception(state: Dict[str, Any],
                           params_enc: Dict[str, Any],
                           stats_enc: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Cadene/pretrainedmodels ``xception`` (timm ``legacy_xception``) state
    dict → classic XceptionEncoder tree.

    Block internals live under ``block{k}.rep.{idx}`` where the indices of
    the separable convs depend on ``start_with_relu`` — instead of
    hardcoding them, the separable convs are discovered by scanning for
    ``.conv1.weight`` (depthwise) at each index; the paired BN always sits
    at ``idx+1``.  ``fc``/``last_linear`` dropped.
    """
    if "conv1.weight" not in state or "block1.rep.0.conv1.weight" not in state:
        raise PretrainedWeightsError(
            "state dict has no conv1/block1.rep — not a Cadene-style "
            "xception?")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    def put_sep(dst: Dict[str, Any], tprefix: str):
        _put_conv(state, dst["depthwise"], f"{tprefix}.conv1.weight")
        _put_conv(state, dst["pointwise"], f"{tprefix}.pointwise.weight")

    _put_conv(state, params["stem_conv1"], "conv1.weight")
    _put_bn(state, params["stem_bn1"], stats["stem_bn1"], "bn1")
    _put_conv(state, params["stem_conv2"], "conv2.weight")
    _put_bn(state, params["stem_bn2"], stats["stem_bn2"], "bn2")

    nblocks = 0
    while f"block{nblocks + 1}.rep.0.conv1.weight" in state \
            or f"block{nblocks + 1}.rep.1.conv1.weight" in state:
        nblocks += 1
    want_blocks = sum(1 for k in params if re.fullmatch(r"block\d+", k))
    if nblocks != want_blocks:
        raise PretrainedWeightsError(
            f"xception depth mismatch: state dict has {nblocks} blocks, "
            f"encoder expects {want_blocks}")

    for k in range(1, nblocks + 1):
        blk_p, blk_s = params[f"block{k}"], stats[f"block{k}"]
        sep_idx = sorted(
            int(m.group(1)) for key in state
            if (m := re.fullmatch(rf"block{k}\.rep\.(\d+)\.conv1\.weight",
                                  key)))
        want_seps = sum(1 for s in blk_p if s.startswith("sep"))
        if len(sep_idx) != want_seps:
            raise PretrainedWeightsError(
                f"block{k}: {len(sep_idx)} separable convs in state dict, "
                f"encoder expects {want_seps}")
        for si, idx in enumerate(sep_idx):
            put_sep(blk_p[f"sep{si + 1}"], f"block{k}.rep.{idx}")
            _put_bn(state, blk_p[f"bn{si + 1}"], blk_s[f"bn{si + 1}"],
                    f"block{k}.rep.{idx + 1}")
        if f"block{k}.skip.weight" in state:
            if "shortcut" not in blk_p:
                raise PretrainedWeightsError(
                    f"block{k} has skip weights but the encoder block is "
                    "identity-residual — layout mismatch")
            _put_conv(state, blk_p["shortcut"], f"block{k}.skip.weight")
            _put_bn(state, blk_p["shortcut_bn"], blk_s["shortcut_bn"],
                    f"block{k}.skipbn")

    put_sep(params["exit_sep1"], "conv3")
    _put_bn(state, params["exit_bn1"], stats["exit_bn1"], "bn3")
    put_sep(params["exit_sep2"], "conv4")
    _put_bn(state, params["exit_bn2"], stats["exit_bn2"], "bn4")
    return params, stats


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def torch_converter_for(backbone: str):
    """The torch-format converter covering ``backbone``; every name of
    ``encoders.ENCODERS`` resolves, ``xception_aligned`` to an error."""
    if backbone.startswith(("resnet", "seresnet", "resnext", "seresnext",
                        "senet")):
        return convert_torch_resnet
    if backbone.startswith("efficientnet"):
        return convert_torch_efficientnet
    if backbone == "mobilenetv2":
        return convert_torch_mobilenetv2
    if backbone in ("mobilenet", "mobilenetv1"):
        return convert_torch_mobilenetv1
    if backbone.startswith("vgg"):
        return convert_torch_vgg
    if backbone.startswith("densenet"):
        return convert_torch_densenet
    if backbone == "inceptionv3":
        return convert_torch_inceptionv3
    if backbone == "inceptionresnetv2":
        return convert_torch_inceptionresnetv2
    if backbone == "xception":
        return convert_torch_xception
    if backbone == "xception_aligned":
        # the pascal_voc DeepLab graph ships as Keras h5 (bonlime);
        # there is no canonical torch state-dict naming for it
        raise PretrainedWeightsError(
            "xception_aligned weights come from the bonlime DeepLabV3+ "
            "Keras release — drop the pascal_voc .h5 (or an .npz export) "
            "in STP_PRETRAINED_DIR; torch .pt ingestion is not defined "
            "for this graph")
    raise PretrainedWeightsError(
        f"no torch-format converter for backbone {backbone!r} "
        f"(use npz export instead)")

def resolve_pretrained_path(backbone: str, spec: str,
                            quiet: bool = False) -> Optional[str]:
    """``encoder_weights`` spec → weights file path, or None when a named
    spec ('imagenet' …) has no local file.  Shared by the loader below and
    the model factory (which must know BEFORE building whether a Keras
    ``.h5`` is in play — resnet18/34 h5 weights require the pre-activation
    encoder variant)."""
    if not spec:
        return None
    if spec in NAMED_SPECS:
        root = os.environ.get(
            "STP_PRETRAINED_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "stp_pretrained"))
        for ext in NAMED_EXTENSIONS:
            cand = os.path.join(root, backbone + ext)
            if os.path.exists(cand):
                return cand
        if quiet:
            return None
        msg = (
            f"encoder_weights={spec!r} requested but no local weights "
            f"found under {root} for backbone {backbone!r}; training "
            "from scratch.  Drop a torchvision-style state dict at "
            f"{os.path.join(root, backbone + '.pt')} (or a Keras .h5) "
            "to enable.")
        # strict mode: a user expecting the reference's accuracy should
        # not silently train from scratch
        if os.environ.get("STP_REQUIRE_PRETRAINED", "").strip() not in (
                "", "0", "false"):
            raise PretrainedWeightsError(
                msg + "  (STP_REQUIRE_PRETRAINED is set: erroring "
                "instead of degrading to random init.)")
        warnings.warn(msg)
        return None
    return spec


def load_encoder_weights(backbone: str, spec: str,
                         variables: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Resolve ``encoder_weights`` config → new variables (or None if the
    spec was 'imagenet' and no local file exists)."""
    path = resolve_pretrained_path(backbone, spec)
    if path is None:
        return None
    if not os.path.exists(path):
        raise PretrainedWeightsError(f"encoder weights file not found: {path}")

    params_enc = variables["params"]["encoder"]
    stats_enc = variables.get("batch_stats", {}).get("encoder", {})
    if path.endswith(".npz"):
        new_p, new_s = _load_npz_into(path, params_enc, stats_enc)
    elif path.endswith((".h5", ".hdf5")):
        from .keras_h5 import load_h5_into

        new_p, new_s = load_h5_into(path, backbone, params_enc, stats_enc)
    elif path.endswith((".pt", ".pth")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
        state = {k: v.numpy() if hasattr(v, "numpy") else v
                 for k, v in state.items()}
        new_p, new_s = torch_converter_for(backbone)(state, params_enc,
                                                     stats_enc)
    else:
        raise PretrainedWeightsError(
            f"unsupported weights format: {path} (want .pt/.pth/.h5/.npz)")

    out = dict(variables)
    out_params = dict(variables["params"])
    out_params["encoder"] = new_p
    out["params"] = out_params
    if "batch_stats" in variables:
        out_stats = dict(variables["batch_stats"])
        out_stats["encoder"] = new_s
        out["batch_stats"] = out_stats
    if (backbone == "xception_aligned"
            and path.endswith((".h5", ".hdf5"))):
        # bonlime pascal_voc saves carry the DeepLab decoder + logits too
        from .keras_h5 import maybe_load_aligned_deeplab_head

        out = maybe_load_aligned_deeplab_head(path, out)
    return out


def load_into_model(model: torch.nn.Module, backbone: str,
                    spec: str) -> bool:
    """Load ``encoder_weights`` ``spec`` into ``model`` (a
    ``SegmentationModel``) in place: its state dict goes into the tree
    layout of ``models.bridge``, through :func:`load_encoder_weights`, and
    back, on the model's device.  False (and the model unchanged) when a
    named spec has no local file."""
    state = model.state_dict()
    loaded = load_encoder_weights(backbone, spec,
                                  bridge.jax_from_state_dict(state))
    if loaded is None:
        return False
    new = bridge.state_dict_from_jax(loaded)
    model.load_state_dict({k: new[k].to(v.device, v.dtype)
                           for k, v in state.items()})
    return True
