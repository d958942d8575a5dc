"""Keras ``.h5`` encoder weights for every backbone of the zoo.

Counterpart of ``segmentation_training_pipeline_tpu/models/keras_h5.py``
(a copy: the port imports nothing of that package).  It reads the Keras
HDF5 layout (top-level or ``model_weights`` group, layer groups with
``weight_names`` attributes) with ``h5py``, imported when a file is read,
and converts into the encoder trees of ``models.bridge``:

* **resnet18/34/50/101/152, seresnet18/34** → the pre-activation
  ``PreactResNetEncoder`` variants (classification_models' graphs:
  basic/bottleneck/ChannelSE; the factory selects the variant when the
  resolved weights file is ``.h5``, and the checkpoint sidecar pins it);
* **vgg16/19** → keras.applications naming (``block{i}_conv{j}``); conv
  biases fold exactly into the encoder's BatchNorm (mean ← −bias,
  var ← 1−eps, so the BN is the identity plus the bias);
* **mobilenet (v1) / mobilenetv2, efficientnetb0–7, densenet121/169/201,
  xception** → keras.applications / qubvel-efficientnet layer naming;
* **inceptionv3 / inceptionresnetv2** → creation-ordered unnamed layers
  zipped onto the torch converters' key sequences;
* **seresnet50/101/152, seresnext50/101, resnext50/101, senet154** →
  creation-order structural matching with full shape validation (a wrong
  guess errors instead of corrupting, see ``convert_h5_cadene_senet``);
* **xception_aligned** → bonlime DeepLabV3+ ``pascal_voc`` full-model
  saves (encoder + decoder + logits head).

Keras Conv kernels are already HWIO (no transpose); DepthwiseConv2D
kernels are (H, W, C, 1) and transpose to the grouped (H, W, 1, C).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .pretrained import PretrainedWeightsError, tree_copy


def read_h5_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Keras HDF5 → ``{layer_name: {short_weight_name: array}}``.

    Handles both save flavors (weights-only files with layers at top level;
    full-model saves under ``model_weights``).  Weight keys are shortened
    to their last path component without the ``:0`` suffix (``kernel``,
    ``bias``, ``gamma``, ``beta``, ``moving_mean``, ``moving_variance``,
    ``depthwise_kernel``).
    """
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise PretrainedWeightsError(
            "h5py is required to read Keras .h5 weights") from e

    def _s(x):
        return x.decode() if isinstance(x, bytes) else str(x)

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in g.attrs:
            raise PretrainedWeightsError(
                f"{path}: no layer_names attr — not a Keras weights file?")
        for lname in [_s(n) for n in g.attrs["layer_names"]]:
            lg = g[lname]
            weights: Dict[str, np.ndarray] = {}
            for wname in [_s(n) for n in lg.attrs.get("weight_names", [])]:
                short = wname.split("/")[-1].split(":")[0]
                weights[short] = np.asarray(lg[wname])
            if weights:
                out[lname] = weights
    return out


def _put_kernel(layers, lname: str, dst: Dict[str, Any],
                key: str = "kernel", depthwise: bool = False):
    if lname not in layers or key not in layers[lname]:
        raise PretrainedWeightsError(f"h5 is missing layer {lname!r} ({key})")
    w = layers[lname][key]
    if depthwise:
        w = np.transpose(w, (0, 1, 3, 2))  # (H,W,C,1) → (H,W,1,C)
    tgt = dst["kernel"]
    if tuple(tgt.shape) != w.shape:
        raise PretrainedWeightsError(
            f"{lname}: shape {w.shape} != target {tuple(tgt.shape)}")
    dst["kernel"] = w.astype(tgt.dtype)


def _put_bn(layers, lname: str, dst_p: Dict[str, Any],
            dst_s: Dict[str, Any]):
    if lname not in layers:
        raise PretrainedWeightsError(f"h5 is missing BN layer {lname!r}")
    lw = layers[lname]
    pairs = [("gamma", dst_p, "scale"), ("beta", dst_p, "bias"),
             ("moving_mean", dst_s, "mean"),
             ("moving_variance", dst_s, "var")]
    for kkey, tree, fkey in pairs:
        if fkey not in tree:
            if kkey == "gamma":   # scale-free BN (bn_data) has no gamma
                continue
            raise PretrainedWeightsError(f"{lname}: encoder BN lacks {fkey}")
        v = lw.get(kkey)
        if v is None:
            raise PretrainedWeightsError(f"{lname}: h5 BN lacks {kkey}")
        tgt = tree[fkey]
        if tuple(tgt.shape) != v.shape:
            raise PretrainedWeightsError(
                f"{lname}.{kkey}: shape {v.shape} != {tuple(tgt.shape)}")
        tree[fkey] = v.astype(tgt.dtype)


# ---------------------------------------------------------------------------
# classification_models preact resnet18/34
# ---------------------------------------------------------------------------

def convert_h5_resnet_preact(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """classification_models resnet h5 → PreactResNetEncoder tree.

    Covers all three zoo variants built on the same ``stage/unit`` naming:
    basic (resnet18/34), bottleneck (resnet50/101/152 — extra
    conv3/bn3 layers, same scheme), and ChannelSE attention
    (seresnet18/34).  encoder submodule names mirror the Keras layer names,
    so named layers walk 1:1; the SE convs are the zoo's only UNNAMED
    layers (Keras auto-names them ``conv2d``, ``conv2d_1``, …) and are
    assigned pairwise — (reduce, expand) per unit in creation order,
    which is (stage, unit) order.  Every assignment is shape-checked."""
    if "bn_data" not in layers or "conv0" not in layers:
        raise PretrainedWeightsError(
            "h5 has no bn_data/conv0 layers — not a classification_models "
            "preact resnet?  (torchvision-style resnets use .pt weights)")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    import re
    auto_convs = sorted(
        (ln for ln in layers if re.fullmatch(r"conv2d(_\d+)?", ln)),
        key=lambda n: int(n.split("_")[1]) if "_" in n else -1)
    se_units = sorted(
        (n for n in params if n.endswith("_se")),
        key=lambda n: (int(re.match(r"stage(\d+)_unit(\d+)", n).group(1)),
                       int(re.match(r"stage(\d+)_unit(\d+)", n).group(2))))
    if se_units and len(auto_convs) != 2 * len(se_units):
        raise PretrainedWeightsError(
            f"encoder has {len(se_units)} SE units but the h5 carries "
            f"{len(auto_convs)} unnamed conv layers (need exactly 2 per "
            "unit) — not a seresnet h5?")
    if auto_convs and not se_units:
        raise PretrainedWeightsError(
            f"h5 carries {len(auto_convs)} unnamed (SE) conv layers but the "
            "encoder has no SE units — use the seresnet backbone?")

    for name, sub in params.items():
        if name.endswith("_se"):
            i = se_units.index(name)
            for j, part in enumerate(("reduce", "expand")):
                lname = auto_convs[2 * i + j]
                _put_kernel(layers, lname, sub[part])
                bias = layers[lname].get("bias")
                if bias is None:
                    raise PretrainedWeightsError(
                        f"{lname}: SE conv expects a bias the h5 lacks")
                sub[part]["bias"] = bias.astype(sub[part]["bias"].dtype)
        elif "kernel" in sub:
            _put_kernel(layers, name, sub)
        else:  # BatchNorm
            _put_bn(layers, name, sub, stats[name])
    # depth check: every stage unit present in the h5 must exist in the tree
    h5_units = {m.group(0) for ln in layers
                if (m := re.match(r"stage\d+_unit\d+", ln))}
    enc_units = {m.group(0) for ln in params
                 if (m := re.match(r"stage\d+_unit\d+", ln))}
    if h5_units - enc_units:
        raise PretrainedWeightsError(
            f"h5 has units the encoder lacks: {sorted(h5_units - enc_units)}"
            " — wrong resnet depth (18 vs 34)?")
    h5_convs = {ln for ln in layers if re.match(r"stage\d+_unit\d+_conv3", ln)}
    enc_convs = {ln for ln in params if re.match(r"stage\d+_unit\d+_conv3", ln)}
    if bool(h5_convs) != bool(enc_convs):
        raise PretrainedWeightsError(
            "basic/bottleneck mismatch: h5 "
            f"{'has' if h5_convs else 'lacks'} conv3 layers but the encoder "
            f"{'has' if enc_convs else 'lacks'} them (resnet34 vs resnet50?)")
    return params, stats


# ---------------------------------------------------------------------------
# keras.applications VGG16/19
# ---------------------------------------------------------------------------

def convert_h5_vgg(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications ``block{i}_conv{j}`` naming → VGGEncoder.

    The Keras VGG has conv biases and no BN; the encoder runs BN after each
    conv.  The bias folds into the (otherwise untrained) BN exactly:
    mean ← −bias, var ← 1 − eps, scale ← 1, beta ← 0 gives
    ``(x+b−0)·1/√((1−eps)+eps) = x + b`` bit-exactly in fp32.
    """
    if "block1_conv1" not in layers:
        raise PretrainedWeightsError(
            "h5 has no block1_conv1 — not a keras.applications vgg?")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    stage = 1
    while f"stage{stage}_conv1" in params:
        c = 1
        while f"stage{stage}_conv{c}" in params:
            lname = f"block{stage}_conv{c}"
            dst = params[f"stage{stage}_conv{c}"]
            _put_kernel(layers, lname, dst)
            bias = layers[lname].get("bias")
            if bias is None:
                raise PretrainedWeightsError(f"{lname}: h5 conv has no bias")
            bn_name = f"stage{stage}_bn{c}"
            if bn_name in params:  # fold the bias into the identity BN
                bn_p, bn_s = params[bn_name], stats[bn_name]
                if tuple(bn_s["mean"].shape) != bias.shape:
                    raise PretrainedWeightsError(
                        f"{lname}.bias: shape {bias.shape} != "
                        f"{tuple(bn_s['mean'].shape)}")
                eps = 1e-5  # VGGEncoder's BN epsilon
                bn_s["mean"] = (-bias).astype(bn_s["mean"].dtype)
                bn_s["var"] = np.full_like(bn_s["var"], 1.0 - eps)
                bn_p["scale"] = np.ones_like(bn_p["scale"])
                bn_p["bias"] = np.zeros_like(bn_p["bias"])
            elif "bias" in dst:
                dst["bias"] = bias.astype(dst["bias"].dtype)
            c += 1
        stage += 1
    n_h5 = sum(1 for ln in layers if ln.startswith("block")
               and "_conv" in ln)
    n_enc = sum(1 for ln in params if "_conv" in ln)
    if n_h5 != n_enc:
        raise PretrainedWeightsError(
            f"vgg depth mismatch: h5 has {n_h5} convs, encoder {n_enc} "
            "(vgg16 vs vgg19?)")
    return params, stats


# ---------------------------------------------------------------------------
# keras.applications MobileNetV2
# ---------------------------------------------------------------------------

def convert_h5_mobilenetv2(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications MobileNetV2 naming → MobileNetV2Encoder."""
    if "Conv1" not in layers:
        raise PretrainedWeightsError(
            "h5 has no Conv1 layer — not a keras.applications mobilenetv2?")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_kernel(layers, "Conv1", params["stem_conv"])
    _put_bn(layers, "bn_Conv1", params["stem_bn"], stats["stem_bn"])

    bi = 0
    while f"block{bi}" in params:
        blk_p, blk_s = params[f"block{bi}"], stats[f"block{bi}"]
        prefix = "expanded_conv" if bi == 0 else f"block_{bi}"
        if "expand" in blk_p:
            _put_kernel(layers, f"{prefix}_expand", blk_p["expand"])
            _put_bn(layers, f"{prefix}_expand_BN", blk_p["expand_bn"],
                    blk_s["expand_bn"])
        elif f"{prefix}_expand" in layers:
            raise PretrainedWeightsError(
                f"h5 has {prefix}_expand but encoder block{bi} has no "
                "expand conv — block layout mismatch")
        _put_kernel(layers, f"{prefix}_depthwise", blk_p["depthwise"],
                    key="depthwise_kernel", depthwise=True)
        _put_bn(layers, f"{prefix}_depthwise_BN", blk_p["dw_bn"],
                blk_s["dw_bn"])
        _put_kernel(layers, f"{prefix}_project", blk_p["project"])
        _put_bn(layers, f"{prefix}_project_BN", blk_p["project_bn"],
                blk_s["project_bn"])
        bi += 1
    if f"block_{bi}_depthwise" in layers:
        raise PretrainedWeightsError(
            f"h5 has block_{bi} but the encoder ends at block{bi - 1} — "
            "depth mismatch")
    _put_kernel(layers, "Conv_1", params["head_conv"])
    _put_bn(layers, "Conv_1_bn", params["head_bn"], stats["head_bn"])
    return params, stats


# ---------------------------------------------------------------------------
# qubvel-efficientnet / keras.applications EfficientNet B0-B7
# ---------------------------------------------------------------------------

def convert_h5_efficientnet(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """``stem_conv``/``block{B}{letter}_*``/``top_conv`` naming (the
    qubvel ``efficientnet`` package behind segmentation_models' b0–b7,
    same scheme keras.applications later adopted) → EfficientNetEncoder.

    Keras block ``{B}{letter}`` maps to our ``stage{B-1}_block{letter_idx}``;
    SE convs carry biases on both sides; depthwise kernels transpose
    (k,k,C,1) → (k,k,1,C)."""
    import re
    import string

    if "stem_conv" not in layers or "block1a_dwconv" not in layers:
        raise PretrainedWeightsError(
            "h5 has no stem_conv/block1a_dwconv layers — not an "
            "efficientnet h5? (keras.applications/qubvel naming expected)")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_kernel(layers, "stem_conv", params["stem_conv"])
    _put_bn(layers, "stem_bn", params["stem_bn"], stats["stem_bn"])

    def _put_se(prefix, se_p):
        for src, dst in (("se_reduce", "reduce"), ("se_expand", "expand")):
            lname = f"{prefix}_{src}"
            _put_kernel(layers, lname, se_p[dst])
            bias = layers[lname].get("bias")
            if bias is None:
                raise PretrainedWeightsError(
                    f"{lname}: SE conv expects a bias the h5 lacks")
            se_p[dst]["bias"] = bias.astype(se_p[dst]["bias"].dtype)

    seen = set()
    for name in list(params):
        m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
        if not m:
            continue
        si, bi = int(m.group(1)), int(m.group(2))
        prefix = f"block{si + 1}{string.ascii_lowercase[bi]}"
        blk_p, blk_s = params[name], stats[name]
        if "expand" in blk_p:
            _put_kernel(layers, f"{prefix}_expand_conv", blk_p["expand"])
            _put_bn(layers, f"{prefix}_expand_bn", blk_p["expand_bn"],
                    blk_s["expand_bn"])
        elif f"{prefix}_expand_conv" in layers:
            raise PretrainedWeightsError(
                f"h5 has {prefix}_expand_conv but encoder {name} has no "
                "expand conv — width/depth mismatch (wrong b-variant?)")
        _put_kernel(layers, f"{prefix}_dwconv", blk_p["depthwise"],
                    key="depthwise_kernel", depthwise=True)
        _put_bn(layers, f"{prefix}_bn", blk_p["dw_bn"], blk_s["dw_bn"])
        _put_se(prefix, blk_p["se"])
        _put_kernel(layers, f"{prefix}_project_conv", blk_p["project"])
        _put_bn(layers, f"{prefix}_project_bn", blk_p["project_bn"],
                blk_s["project_bn"])
        seen.add(prefix)
    extra = {ln.split("_")[0] for ln in layers
             if re.match(r"block\d+[a-z]_dwconv", ln)} - seen
    if extra:
        raise PretrainedWeightsError(
            f"h5 has blocks the encoder lacks: {sorted(extra)} — depth "
            "mismatch (wrong b-variant?)")
    _put_kernel(layers, "top_conv", params["head_conv"])
    _put_bn(layers, "top_bn", params["head_bn"], stats["head_bn"])
    return params, stats


# ---------------------------------------------------------------------------
# keras.applications DenseNet 121/169/201
# ---------------------------------------------------------------------------

def convert_h5_densenet(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications DenseNet naming → DenseNetEncoder:
    ``conv1/conv``+``conv1/bn`` stem, ``conv{b}_block{l}_{0_bn,1_conv,
    1_bn,2_conv}`` dense layers (b=2..5), ``pool{b}_{bn,conv}``
    transitions, final ``bn``."""
    import re

    if "conv1/conv" not in layers or "conv2_block1_1_conv" not in layers:
        raise PretrainedWeightsError(
            "h5 has no conv1/conv + conv2_block1_1_conv layers — not a "
            "keras.applications densenet?")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_kernel(layers, "conv1/conv", params["stem_conv"])
    _put_bn(layers, "conv1/bn", params["stem_bn"], stats["stem_bn"])

    for name in list(params):
        m = re.fullmatch(r"block(\d+)_layer(\d+)", name)
        if m:
            b, l = int(m.group(1)) + 1, int(m.group(2))
            blk_p, blk_s = params[name], stats[name]
            _put_bn(layers, f"conv{b}_block{l}_0_bn", blk_p["bn1"],
                    blk_s["bn1"])
            _put_kernel(layers, f"conv{b}_block{l}_1_conv", blk_p["conv1"])
            _put_bn(layers, f"conv{b}_block{l}_1_bn", blk_p["bn2"],
                    blk_s["bn2"])
            _put_kernel(layers, f"conv{b}_block{l}_2_conv", blk_p["conv2"])
            continue
        m = re.fullmatch(r"trans(\d+)_conv", name)
        if m:
            b = int(m.group(1)) + 1
            _put_kernel(layers, f"pool{b}_conv", params[name])
            _put_bn(layers, f"pool{b}_bn", params[f"trans{m.group(1)}_bn"],
                    stats[f"trans{m.group(1)}_bn"])
    _put_bn(layers, "bn", params["final_bn"], stats["final_bn"])

    h5_layers = {ln for ln in layers
                 if re.fullmatch(r"conv\d+_block\d+_1_conv", ln)}
    enc_layers = {f"conv{int(m.group(1)) + 1}_block{m.group(2)}_1_conv"
                  for ln in params
                  if (m := re.fullmatch(r"block(\d+)_layer(\d+)", ln))}
    if h5_layers != enc_layers:
        raise PretrainedWeightsError(
            f"densenet depth mismatch: h5 has {len(h5_layers)} dense "
            f"layers, encoder {len(enc_layers)} (121 vs 169 vs 201?)")
    return params, stats


# ---------------------------------------------------------------------------
# keras.applications MobileNet (v1)
# ---------------------------------------------------------------------------

def convert_h5_mobilenetv1(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications MobileNet naming (``conv1``, ``conv_dw_{i}``,
    ``conv_pw_{i}`` + ``_bn`` suffixes) → MobileNetV1Encoder.  Our encoder
    submodule names equal the Keras layer names, so the walk is 1:1."""
    if "conv_dw_1" not in layers:
        raise PretrainedWeightsError(
            "h5 has no conv_dw_1 layer — not a keras.applications "
            "mobilenet (v1)?  (mobilenet_v2 h5 uses the mobilenetv2 "
            "backbone)")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)
    for name, sub in params.items():
        if "kernel" in sub:
            dw = name.startswith("conv_dw")
            _put_kernel(layers, name, sub,
                        key="depthwise_kernel" if dw else "kernel",
                        depthwise=dw)
        else:
            _put_bn(layers, name, sub, stats[name])
    if "conv_dw_14" in layers:
        raise PretrainedWeightsError(
            "h5 has a conv_dw_14 layer; mobilenet v1 ends at 13 — "
            "wrong model?")
    return params, stats


# ---------------------------------------------------------------------------
# keras.applications Xception (classic graph)
# ---------------------------------------------------------------------------

def _put_sepconv(layers, lname: str, sep_p: Dict[str, Any]):
    """Keras SeparableConv2D (``depthwise_kernel`` (3,3,C,1) +
    ``pointwise_kernel`` (1,1,C,F)) → our SeparableConv submodule."""
    if lname not in layers:
        raise PretrainedWeightsError(f"h5 is missing sepconv {lname!r}")
    lw = layers[lname]
    for key, sub, tr in (("depthwise_kernel", sep_p["depthwise"], True),
                         ("pointwise_kernel", sep_p["pointwise"], False)):
        w = lw.get(key)
        if w is None:
            raise PretrainedWeightsError(f"{lname}: h5 sepconv lacks {key}")
        if tr:
            w = np.transpose(w, (0, 1, 3, 2))  # (3,3,C,1) → (3,3,1,C)
        tgt = sub["kernel"]
        if tuple(tgt.shape) != w.shape:
            raise PretrainedWeightsError(
                f"{lname}.{key}: shape {w.shape} != {tuple(tgt.shape)}")
        sub["kernel"] = w.astype(tgt.dtype)


def convert_h5_xception(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications Xception → XceptionEncoder.

    Keras numbers blocks 1..14 where block1 is the stem and block14 the two
    exit sepconvs; our encoder names them stem/block1..12/exit_sep{1,2}
    (offset of one).  The four residual-shortcut convs are the graph's only
    UNNAMED layers (auto ``conv2d_N`` + ``batch_normalization_N``), created
    in block order (keras blocks 2, 3, 4, 13) before each block's
    sepconvs."""
    import re

    if "block1_conv1" not in layers or "block2_sepconv1" not in layers:
        raise PretrainedWeightsError(
            "h5 has no block1_conv1/block2_sepconv1 layers — not a "
            "keras.applications xception?  (the DeepLab variant uses the "
            "xception_aligned backbone)")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    _put_kernel(layers, "block1_conv1", params["stem_conv1"])
    _put_bn(layers, "block1_conv1_bn", params["stem_bn1"], stats["stem_bn1"])
    _put_kernel(layers, "block1_conv2", params["stem_conv2"])
    _put_bn(layers, "block1_conv2_bn", params["stem_bn2"], stats["stem_bn2"])

    auto_convs = sorted(
        (ln for ln in layers if re.fullmatch(r"conv2d(_\d+)?", ln)),
        key=lambda n: int(n.split("_")[1]) if "_" in n else -1)
    auto_bns = sorted(
        (ln for ln in layers
         if re.fullmatch(r"batch_normalization(_\d+)?", ln)),
        key=lambda n: int(n.split("_")[-1]) if n[-1].isdigit() else -1)
    shortcut_blocks = [n for n in sorted(
        params, key=lambda n: int(n.replace("block", ""))
        if n.startswith("block") else 99)
        if n.startswith("block") and "shortcut" in params[n]]
    if len(auto_convs) != len(shortcut_blocks) or \
            len(auto_bns) != len(shortcut_blocks):
        raise PretrainedWeightsError(
            f"encoder has {len(shortcut_blocks)} shortcut convs but the h5 "
            f"carries {len(auto_convs)} unnamed convs / {len(auto_bns)} "
            "unnamed BNs — not a classic xception h5?")

    n_blocks = len([n for n in params if re.fullmatch(r"block\d+", n)])
    for name in sorted(params):
        m = re.fullmatch(r"block(\d+)", name)
        if not m:
            continue
        ours = int(m.group(1))
        kb = ours + 1                       # keras block number
        blk_p, blk_s = params[name], stats[name]
        si = 1
        while f"sep{si}" in blk_p:
            _put_sepconv(layers, f"block{kb}_sepconv{si}", blk_p[f"sep{si}"])
            _put_bn(layers, f"block{kb}_sepconv{si}_bn", blk_p[f"bn{si}"],
                    blk_s[f"bn{si}"])
            si += 1
        if "shortcut" in blk_p:
            i = shortcut_blocks.index(name)
            _put_kernel(layers, auto_convs[i], blk_p["shortcut"])
            _put_bn(layers, auto_bns[i], blk_p["shortcut_bn"],
                    blk_s["shortcut_bn"])
    kb_exit = n_blocks + 2                  # keras block14 for 12 blocks
    _put_sepconv(layers, f"block{kb_exit}_sepconv1", params["exit_sep1"])
    _put_bn(layers, f"block{kb_exit}_sepconv1_bn", params["exit_bn1"],
            stats["exit_bn1"])
    _put_sepconv(layers, f"block{kb_exit}_sepconv2", params["exit_sep2"])
    _put_bn(layers, f"block{kb_exit}_sepconv2_bn", params["exit_bn2"],
            stats["exit_bn2"])
    if f"block{kb_exit + 1}_sepconv1" in layers:
        raise PretrainedWeightsError(
            f"h5 has block{kb_exit + 1} layers beyond the encoder's depth "
            "— middle-flow depth mismatch?")
    return params, stats


# ---------------------------------------------------------------------------
# keras.applications InceptionV3 / InceptionResNetV2
#
# Both Keras graphs build every conv through `conv2d_bn` with NO layer name
# (auto `conv2d_N` / `batch_normalization_N`, creation order == code order;
# the shipped imagenet h5 files literally number them 1..94).  Rather than
# duplicate the graph walk, these converters synthesize a torch-style state
# dict by zipping the ordered unnamed layers with the torchvision/timm key
# sequence IN KERAS CREATION ORDER, then reuse the proven torch converters
# (models/pretrained.py).  Kernels transpose HWIO→OIHW on the way in (the
# torch converter transposes back — exact).  Keras BNs are scale-free
# (gamma absent): gamma synthesizes to ones.
# ---------------------------------------------------------------------------

def _ordered_auto(layers, base: str):
    """Unnamed-layer names (``base``, ``base_1``, …) in numeric order —
    Keras global-counter naming may start at ``base`` or ``base_1``."""
    import re
    return sorted(
        (ln for ln in layers if re.fullmatch(rf"{base}(_\d+)?", ln)),
        key=lambda n: int(n.split("_")[-1]) if n[-1].isdigit() else 0)


def _synth_cbr(state, layers, conv_l: str, bn_l: str, tprefix: str,
               scale_free: bool = True):
    """One Keras conv+BN layer pair → torch BasicConv2d keys under
    ``tprefix`` (conv.weight HWIO→OIHW; gamma→weight with ones default)."""
    kw = layers[conv_l].get("kernel")
    if kw is None:
        raise PretrainedWeightsError(f"{conv_l}: h5 layer has no kernel")
    state[f"{tprefix}.conv.weight"] = np.transpose(kw, (3, 2, 0, 1))
    lb = layers[bn_l]
    for src, dst in (("beta", "bias"), ("moving_mean", "running_mean"),
                     ("moving_variance", "running_var")):
        if src not in lb:
            raise PretrainedWeightsError(f"{bn_l}: h5 BN lacks {src}")
        state[f"{tprefix}.bn.{dst}"] = lb[src]
    gamma = lb.get("gamma")
    if gamma is None:
        if not scale_free:
            raise PretrainedWeightsError(f"{bn_l}: h5 BN lacks gamma")
        gamma = np.ones_like(lb["beta"])
    state[f"{tprefix}.bn.weight"] = gamma


# torchvision inception_v3 BasicConv2d prefixes in KERAS CREATION ORDER
def _inc3_torch_sequence():
    seq = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
           "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
    a = ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
         "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"]
    for s in "bcd":
        seq += [f"Mixed_5{s}.{b}" for b in a]
    seq += [f"Mixed_6a.{b}" for b in
            ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
             "branch3x3dbl_3")]
    bblk = ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
            "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
            "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"]
    for s in "bcde":
        seq += [f"Mixed_6{s}.{b}" for b in bblk]
    seq += [f"Mixed_7a.{b}" for b in
            ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
             "branch7x7x3_3", "branch7x7x3_4")]
    cblk = ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
            "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
            "branch3x3dbl_3b", "branch_pool"]
    for s in "bc":
        seq += [f"Mixed_7{s}.{b}" for b in cblk]
    return seq


def convert_h5_inceptionv3(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications InceptionV3 h5 → InceptionV3Encoder (via the
    torchvision-naming converter; see section comment)."""
    from .pretrained import convert_torch_inceptionv3

    convs = _ordered_auto(layers, "conv2d")
    bns = _ordered_auto(layers, "batch_normalization")
    seq = _inc3_torch_sequence()
    if len(convs) != len(seq) or len(bns) != len(seq):
        raise PretrainedWeightsError(
            f"h5 has {len(convs)} convs / {len(bns)} BNs; keras "
            f"inception_v3 (notop) carries exactly {len(seq)} of each — "
            "wrong model or a with-top save (strip the classifier)?")
    state: Dict[str, Any] = {}
    for conv_l, bn_l, tprefix in zip(convs, bns, seq):
        _synth_cbr(state, layers, conv_l, bn_l, tprefix)
    return convert_torch_inceptionv3(state, params_enc, stats_enc)


# timm inception_resnet_v2 prefixes for the UNNAMED Keras layers, in
# creation order (the residual-scale convs are named block*_conv and the
# final conv conv_7b — handled separately)
def _irv2_torch_sequence():
    seq = ["conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a"]
    seq += [f"mixed_5b.{b}" for b in
            ("branch0", "branch1.0", "branch1.1", "branch2.0", "branch2.1",
             "branch2.2", "branch3.1")]
    b35 = ("branch0", "branch1.0", "branch1.1", "branch2.0", "branch2.1",
           "branch2.2")
    for i in range(10):
        seq += [f"repeat.{i}.{b}" for b in b35]
    seq += [f"mixed_6a.{b}" for b in
            ("branch0", "branch1.0", "branch1.1", "branch1.2")]
    b17 = ("branch0", "branch1.0", "branch1.1", "branch1.2")
    for i in range(20):
        seq += [f"repeat_1.{i}.{b}" for b in b17]
    seq += [f"mixed_7a.{b}" for b in
            ("branch0.0", "branch0.1", "branch1.0", "branch1.1",
             "branch2.0", "branch2.1", "branch2.2")]
    for i in range(9):
        seq += [f"repeat_2.{i}.{b}" for b in b17]
    seq += [f"block8.{b}" for b in b17]
    return seq


def convert_h5_inceptionresnetv2(layers, params_enc,
                                 stats_enc) -> Tuple[Dict, Dict]:
    """keras.applications InceptionResNetV2 h5 → InceptionResNetV2Encoder
    (via the timm-naming converter).  Unnamed conv/BN pairs follow
    creation order; the per-block residual-scale convs are NAMED
    (``block35_{i}_conv`` …, biased, no BN) as is the final ``conv_7b``."""
    from .pretrained import convert_torch_inceptionresnetv2

    if "conv_7b" not in layers or "block35_1_conv" not in layers:
        raise PretrainedWeightsError(
            "h5 has no conv_7b/block35_1_conv layers — not a "
            "keras.applications inception_resnet_v2?")
    convs = _ordered_auto(layers, "conv2d")
    bns = _ordered_auto(layers, "batch_normalization")
    seq = _irv2_torch_sequence()
    if len(convs) != len(seq) or len(bns) != len(seq):
        raise PretrainedWeightsError(
            f"h5 has {len(convs)} unnamed convs / {len(bns)} BNs; keras "
            f"inception_resnet_v2 (notop) carries exactly {len(seq)} — "
            "wrong model or a with-top save?")
    state: Dict[str, Any] = {}
    for conv_l, bn_l, tprefix in zip(convs, bns, seq):
        _synth_cbr(state, layers, conv_l, bn_l, tprefix)

    def put_named_conv(lname: str, tprefix: str):
        lw = layers.get(lname)
        if lw is None or "kernel" not in lw or "bias" not in lw:
            raise PretrainedWeightsError(
                f"h5 is missing named conv {lname!r} (kernel+bias)")
        state[f"{tprefix}.conv2d.weight"] = np.transpose(
            lw["kernel"], (3, 2, 0, 1))
        state[f"{tprefix}.conv2d.bias"] = lw["bias"]

    for i in range(10):
        put_named_conv(f"block35_{i + 1}_conv", f"repeat.{i}")
    for i in range(20):
        put_named_conv(f"block17_{i + 1}_conv", f"repeat_1.{i}")
    for i in range(9):
        put_named_conv(f"block8_{i + 1}_conv", f"repeat_2.{i}")
    put_named_conv("block8_10_conv", "block8")
    _synth_cbr(state, layers, "conv_7b", "conv_7b_bn", "conv2d_7b")
    return convert_torch_inceptionresnetv2(state, params_enc, stats_enc)


# ---------------------------------------------------------------------------
# classification_models senet.py / resnext.py families
# (seresnet50/101/152, seresnext50/101, senet154, resnext50/101)
#
# These zoo graphs are Keras adaptations of the Cadene models with largely
# UNNAMED layers (auto conv2d_N / batch_normalization_N).  The reference
# graphs were not available, so the exact creation order is a [LOW]-
# confidence reconstruction: per block, branch convs (conv→BN pairs) →
# SE convs (biased, no BN) → downsample conv+BN — the Cadene forward
# order.  EVERY assignment is shape-validated and the conv/BN unit counts
# must match exactly, so a wrong order guess fails loudly instead of
# corrupting weights (the only shape-degenerate pair, bn3 vs bn_down, is
# disambiguated by conv→BN adjacency pairing).  First contact with a real
# checkpoint should check the loaded encoder against the source model.
# ---------------------------------------------------------------------------

def convert_h5_cadene_senet(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)

    # --- h5 side: (conv, adjacent-BN) units in stored creation order ----
    items = []
    for ln, lw in layers.items():
        if "kernel" in lw and lw["kernel"].ndim == 2:
            continue  # classifier Dense in a with-top save — ignore
        if "kernel" in lw or "depthwise_kernel" in lw:
            items.append(("conv", ln))
        elif "moving_mean" in lw:
            items.append(("bn", ln))
    units = []  # (conv_lname, bn_lname | None)
    k = 0
    while k < len(items):
        kind, ln = items[k]
        if kind != "conv":
            raise PretrainedWeightsError(
                f"{ln}: BatchNorm with no preceding conv — not a "
                "classification_models senet/resnext h5? (preact resnets "
                "use the named stage/unit converter)")
        if (k + 1 < len(items) and items[k + 1][0] == "bn"
                and "bias" not in layers[ln]):
            units.append((ln, items[k + 1][1]))
            k += 2
        else:
            units.append((ln, None))
            k += 1

    # --- target side: slot walk in Cadene forward order -----------------
    slots = []  # (conv_subtree, bn_params | None, bn_stats | None, label)

    def add(conv_sub, label, bn_name=None, scope_p=None, scope_s=None):
        bn_p = scope_p[bn_name] if bn_name else None
        bn_s = scope_s[bn_name] if bn_name else None
        slots.append((conv_sub, bn_p, bn_s, label))

    if "stem_conv3" in params:  # senet154 deep stem
        for i in (1, 2, 3):
            add(params[f"stem_conv{i}"], f"stem_conv{i}",
                f"stem_bn{i}", params, stats)
    else:
        add(params["stem_conv"], "stem_conv", "stem_bn", params, stats)
    import re
    blocks = sorted(
        (n for n in params if re.fullmatch(r"stage\d+_block\d+", n)),
        key=lambda n: (int(re.findall(r"\d+", n)[0]),
                       int(re.findall(r"\d+", n)[1])))
    for name in blocks:
        blk_p, blk_s = params[name], stats[name]
        n_convs = 3 if "conv3" in blk_p else 2
        for ci in range(1, n_convs + 1):
            add(blk_p[f"conv{ci}"], f"{name}.conv{ci}",
                f"bn{ci}", blk_p, blk_s)
        if "se" in blk_p:
            add(blk_p["se"]["reduce"], f"{name}.se.reduce")
            add(blk_p["se"]["expand"], f"{name}.se.expand")
        if "downsample" in blk_p:
            add(blk_p["downsample"], f"{name}.downsample",
                "bn_down", blk_p, blk_s)

    if len(units) != len(slots):
        raise PretrainedWeightsError(
            f"h5 carries {len(units)} conv layers but the encoder expects "
            f"{len(slots)} — wrong depth/variant? (first slots: "
            f"{[s[3] for s in slots[:3]]})")

    # --- assign with full shape validation -------------------------------
    for (conv_l, bn_l), (conv_sub, bn_p, bn_s, label) in zip(units, slots):
        if (bn_l is None) != (bn_p is None):
            raise PretrainedWeightsError(
                f"slot {label}: {'expects' if bn_p is not None else 'has no'}"
                f" BatchNorm but h5 layer {conv_l!r} "
                f"{'lacks one' if bn_l is None else 'carries one'} — "
                "creation-order mismatch")
        w = layers[conv_l].get("kernel")
        if w is None:
            raise PretrainedWeightsError(f"{conv_l}: h5 layer has no kernel")
        tgt = conv_sub["kernel"]
        if tuple(tgt.shape) != w.shape:
            raise PretrainedWeightsError(
                f"slot {label} ← {conv_l}: shape {w.shape} != "
                f"{tuple(tgt.shape)} — creation-order mismatch or wrong "
                "backbone")
        conv_sub["kernel"] = w.astype(tgt.dtype)
        if "bias" in conv_sub:
            b = layers[conv_l].get("bias")
            if b is None:
                raise PretrainedWeightsError(
                    f"slot {label} expects a bias {conv_l!r} lacks")
            conv_sub["bias"] = b.astype(conv_sub["bias"].dtype)
        if bn_l is not None:
            _put_bn(layers, bn_l, bn_p, bn_s)
    return params, stats


# ---------------------------------------------------------------------------
# bonlime keras-deeplab-v3-plus (aligned Xception-65 + DeepLab decoder)
# ---------------------------------------------------------------------------

def _walk_flat_named(layers, params: Dict, stats: Dict, what: str):
    """Fill a FLAT-named encoder tree (submodule names == Keras layer names)
    from the h5 layer dict; shared by the aligned-xception encoder and the
    aligned DeepLab decoder (models/encoders/xception_aligned.py naming
    contract)."""
    for name, sub in params.items():
        if "kernel" in sub:
            dw = name.endswith("_depthwise")
            _put_kernel(layers, name, sub,
                        key="depthwise_kernel" if dw else "kernel",
                        depthwise=dw)
            if "bias" in sub:
                bias = layers[name].get("bias")
                if bias is None:
                    raise PretrainedWeightsError(
                        f"{name}: {what} conv expects a bias the h5 lacks")
                sub["bias"] = bias.astype(sub["bias"].dtype)
        else:
            _put_bn(layers, name, sub, stats[name])


def convert_h5_aligned_xception(layers, params_enc, stats_enc) -> Tuple[Dict, Dict]:
    """bonlime DeepLabV3+ h5 (full-model ``pascal_voc`` save or an
    encoder-only export) → AlignedXceptionEncoder tree."""
    if "entry_flow_conv1_1" not in layers:
        raise PretrainedWeightsError(
            "h5 has no entry_flow_conv1_1 layer — not a bonlime "
            "aligned-xception (DeepLabV3+) weights file?  (classic "
            "xception checkpoints use the 'xception' backbone)")
    params = tree_copy(params_enc)
    stats = tree_copy(stats_enc)
    _walk_flat_named(layers, params, stats, "encoder")
    return params, stats


def maybe_load_aligned_deeplab_head(path: str, variables: Dict) -> Dict:
    """When a bonlime h5 also carries the DeepLab decoder (+ pascal
    logits), map those into the aligned decoder / logits_conv trees —
    the reference's ``Deeplabv3(weights='pascal_voc')`` loads the WHOLE
    model, not just the backbone.  No-ops (with a warning
    where relevant) when the h5 is encoder-only, the configured decoder
    isn't the aligned graph, or the class count differs."""
    import warnings

    layers = read_h5_weights(path)
    if "concat_projection" not in layers:
        return variables  # encoder-only export
    dec_p = variables["params"].get("decoder", {})
    if "concat_projection" not in dec_p:
        warnings.warn(
            f"{path} carries DeepLab decoder weights but the configured "
            "decoder is not the aligned DeepLab graph — only the encoder "
            "was loaded (use architecture: DeepLabV3 with backbone: "
            "xception_aligned for the full pascal_voc model)")
        return variables

    out = tree_copy(variables)
    _walk_flat_named(layers, out["params"]["decoder"],
                     out["batch_stats"]["decoder"], "decoder")
    head = out["params"].get("logits_conv")
    if head is not None:
        for lname in ("logits_semantic", "custom_logits_semantic"):
            if lname in layers and "kernel" in layers[lname]:
                k = layers[lname]["kernel"]
                if tuple(head["kernel"].shape) == k.shape:
                    head["kernel"] = k.astype(head["kernel"].dtype)
                    if "bias" in head and "bias" in layers[lname]:
                        head["bias"] = layers[lname]["bias"].astype(
                            head["bias"].dtype)
                else:
                    warnings.warn(
                        f"{lname} in {path} has {k.shape[-1]} classes; "
                        f"config wants {head['kernel'].shape[-1]} — "
                        "logits head keeps its fresh init")
                break
    return out


def keras_converter_for(backbone: str):
    if backbone in ("resnet18", "resnet34", "resnet50", "resnet101",
                    "resnet152", "seresnet18", "seresnet34"):
        return convert_h5_resnet_preact
    if backbone.startswith("vgg"):
        return convert_h5_vgg
    if backbone == "mobilenetv2":
        return convert_h5_mobilenetv2
    if backbone in ("mobilenet", "mobilenetv1"):
        return convert_h5_mobilenetv1
    if backbone.startswith("efficientnet"):
        return convert_h5_efficientnet
    if backbone.startswith("densenet"):
        return convert_h5_densenet
    if backbone == "xception":
        return convert_h5_xception
    if backbone == "inceptionv3":
        return convert_h5_inceptionv3
    if backbone == "inceptionresnetv2":
        return convert_h5_inceptionresnetv2
    if backbone.startswith(("seresnet", "seresnext", "resnext", "senet")):
        return convert_h5_cadene_senet
    if backbone == "xception_aligned":
        return convert_h5_aligned_xception
    raise PretrainedWeightsError(
        f"no Keras .h5 converter for backbone {backbone!r} — export the "
        "weights to torch .pt or npz instead (every registered backbone "
        "resolves; tested in test_keras_h5.py)")


def load_h5_into(path: str, backbone: str, params_enc, stats_enc):
    layers = read_h5_weights(path)
    return keras_converter_for(backbone)(layers, params_enc, stats_enc)
