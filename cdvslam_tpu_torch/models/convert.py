"""Carry weights from the JAX package's flax variables into the port.

``load_flax_params(tree)`` takes the JAX SLAM's merged flax variables as
numpy arrays, ``{"params": {"xfeat_f", "dino", "update_op", "posenc_mod"},
"batch_stats": {"xfeat_f": ...}}``, and returns a ``CDVNet`` state dict
under the reference's torch names, the inverse of the JAX package's
``convert_update_cdv`` / ``convert_dino`` / ``convert_xfeat``.
``vonet_state(tree)`` does the same for the JAX DPVO SLAM's variables
(``convert_encoder4`` / ``convert_update_dpv``). ``seg_head_state`` / ``depth_head_state`` / ``dpt_head_state`` do the same
for the JAX SLAM's ``seg_params`` / ``depth_params``, the inverses of
``load_seg_head`` / ``load_depth_head`` / ``load_dpt_head``.

Conventions: Dense kernel (in, out) -> Linear weight (out, in); Conv
kernel (kh, kw, in, out) -> (out, in, kh, kw); LayerNorm scale -> weight;
BatchNorm mean / var -> running_mean / running_var; ConvTranspose kernel
(kh, kw, in, out) -> (in, out, kh, kw) flipped in both spatial axes.

``load_torch_checkpoint(path, version)`` reads a reference ``.pth``: the
port's modules carry the reference's names, so it only strips
``module.``, drops ``update.lmbda`` and checks the keys.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _lin(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _ln(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _mlp2(sd, name, p):
    _lin(sd, f"{name}.0", p["Dense_0"])
    _lin(sd, f"{name}.2", p["Dense_1"])


def _soft_agg(sd, name, p):
    for tname, fname in (("f", "Dense_0"), ("g", "Dense_1"), ("h", "Dense_2")):
        _lin(sd, f"{name}.{tname}", p[fname])


def _update_trunk_state(p, prefix) -> dict:
    """The trunk and heads both update operators share."""
    sd = {}
    c = p["common"]
    _lin(sd, f"{prefix}corr.0", c["corr_0"])
    _lin(sd, f"{prefix}corr.2", c["corr_2"])
    _ln(sd, f"{prefix}corr.3", c["corr_3"])
    _lin(sd, f"{prefix}corr.5", c["corr_5"])
    _ln(sd, f"{prefix}norm", c["norm"])
    _mlp2(sd, f"{prefix}c1", c["c1"])
    _mlp2(sd, f"{prefix}c2", c["c2"])
    _soft_agg(sd, f"{prefix}agg_kk", c["agg_kk"])
    _lin(sd, f"{prefix}d.1", p["heads"]["d"])
    _lin(sd, f"{prefix}w.1", p["heads"]["w"])
    return sd


def update_cdv_state(p, prefix="update.") -> dict:
    """flax ``update_op`` subtree -> ``update.*`` state dict entries."""
    sd = _update_trunk_state(p, prefix)
    _ln(sd, f"{prefix}norm2", p["norm2"])
    g = p["gatten"]
    _lin(sd, f"{prefix}gatten.gate.0", g["gate"])
    enc = f"{prefix}gatten.encoder."
    e = g["encoder"]
    for name in ("q_proj", "k_proj", "v_proj", "merge"):
        _lin(sd, f"{enc}{name}", e[name])
    _ln(sd, f"{enc}norm1", e["norm1"])
    _ln(sd, f"{enc}norm2", e["norm2"])
    _lin(sd, f"{enc}mlp.0", e["mlp_0"])
    _lin(sd, f"{enc}mlp.2", e["mlp_2"])
    return sd


def update_dpv_state(p, prefix="update.") -> dict:
    """flax ``UpdateDPV`` subtree -> ``update.*`` state dict entries;
    inverse of the JAX package's ``convert_update_dpv``."""
    sd = _update_trunk_state(p, prefix)
    _soft_agg(sd, f"{prefix}agg_ij", p["agg_ij"])
    for i in range(2):
        _ln(sd, f"{prefix}gru.{2 * i}", p[f"LayerNorm_{i}"])
        sd.update(gated_residual_state(p[f"GatedResidual_{i}"], f"{prefix}gru.{2 * i + 1}."))
    return sd


def gated_residual_state(p, prefix="") -> dict:
    """flax ``GatedResidual`` params -> ``gate.0`` / ``res.0`` / ``res.2``.

    flax names a compact module's submodules in the order they are
    constructed, and ``Dense(dim)(relu(Dense(dim)(x)))`` constructs the
    outer Dense first: the residual applies ``Dense_2`` first and
    ``Dense_1`` second. So ``res.0`` (the reference applies it first) is
    ``Dense_2``; the JAX package's ``convert_update_dpv`` maps it to
    ``Dense_1`` and so swaps the two (ROADMAP Queue 3)."""
    sd = {}
    _lin(sd, f"{prefix}gate.0", p["Dense_0"])
    _lin(sd, f"{prefix}res.0", p["Dense_2"])
    _lin(sd, f"{prefix}res.2", p["Dense_1"])
    return sd


_ENCODER_BLOCKS = {"ResidualBlock_0": "layer1.0", "ResidualBlock_1": "layer1.1",
                   "ResidualBlock_2": "layer2.0", "ResidualBlock_3": "layer2.1"}


def encoder4_state(p, prefix) -> dict:
    """flax ``BasicEncoder4`` params -> ``<prefix>*`` entries; inverse of
    the JAX package's ``convert_encoder4`` (the norms have no parameters)."""
    sd = {}
    _conv(sd, f"{prefix}conv1", p["Conv_0"])
    for fname, tname in _ENCODER_BLOCKS.items():
        b = p[fname]
        _conv(sd, f"{prefix}{tname}.conv1", b["Conv_0"])
        _conv(sd, f"{prefix}{tname}.conv2", b["Conv_1"])
        if "Conv_2" in b:
            _conv(sd, f"{prefix}{tname}.downsample.0", b["Conv_2"])
    _conv(sd, f"{prefix}conv2", p["Conv_1"])
    return sd


def vonet_state(tree) -> dict:
    """The JAX DPVO SLAM's flax variables, ``{"params": {"fnet", "inet",
    "update_op"}}`` as numpy arrays -> a ``VONet`` state dict."""
    params = tree["params"]
    sd = encoder4_state(params["fnet"], "patchify.fnet.")
    sd.update(encoder4_state(params["inet"], "patchify.inet."))
    sd.update(update_dpv_state(params["update_op"]))
    return sd


def dino_state(p, prefix="patchify.dino.", depth=12) -> dict:
    """flax ``dino`` subtree -> ``patchify.dino.*`` state dict entries."""
    sd = {}
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"])
    _ln(sd, f"{prefix}norm", p["norm"])
    sd[f"{prefix}cls_token"] = _t(p["cls_token"])
    sd[f"{prefix}pos_embed"] = _t(p["pos_embed"])
    for i in range(depth):
        b, base = p[f"block{i}"], f"{prefix}blocks.{i}."
        _ln(sd, f"{base}norm1", b["norm1"])
        _lin(sd, f"{base}attn.qkv", b["attn"]["qkv"])
        _lin(sd, f"{base}attn.proj", b["attn"]["proj"])
        sd[f"{base}ls1.gamma"] = _t(b["ls1"]["gamma"])
        _ln(sd, f"{base}norm2", b["norm2"])
        _lin(sd, f"{base}mlp.fc1", b["mlp"]["fc1"])
        _lin(sd, f"{base}mlp.fc2", b["mlp"]["fc2"])
        sd[f"{base}ls2.gamma"] = _t(b["ls2"]["gamma"])
    return sd


_XFEAT_LAYERS = {"block1_0": "block1.0", "block1_1": "block1.1",
                 "block1_2": "block1.2", "block1_3": "block1.3",
                 "block2_0": "block2.0", "block2_1": "block2.1"}


def xfeat_state(params, stats, prefix="patchify.xfeat.") -> dict:
    """flax ``xfeat`` params + batch_stats -> ``patchify.xfeat.*`` entries."""
    sd = {}
    for fname, tname in _XFEAT_LAYERS.items():
        _conv(sd, f"{prefix}{tname}.layer.0", params[fname]["Conv_0"])
        bn = stats[fname]["BatchNorm_0"]
        sd[f"{prefix}{tname}.layer.1.running_mean"] = _t(bn["mean"])
        sd[f"{prefix}{tname}.layer.1.running_var"] = _t(bn["var"])
        sd[f"{prefix}{tname}.layer.1.num_batches_tracked"] = torch.tensor(0)
    _conv(sd, f"{prefix}skip1.1", params["skip1"])
    return sd


def load_flax_params(tree) -> dict:
    """The JAX SLAM's merged flax variables -> a ``CDVNet`` state dict."""
    params, stats = tree["params"], tree["batch_stats"]
    sd = {}
    sd.update(xfeat_state(params["xfeat_f"]["xfeat"], stats["xfeat_f"]["xfeat"]))
    sd.update(dino_state(params["dino"]))
    sd.update(update_cdv_state(params["update_op"]))
    _lin(sd, "posenc.Wr", params["posenc_mod"]["Dense_0"])
    return sd


def seg_head_state(variables) -> dict:
    """The JAX SLAM's ``seg_params`` (flax ``SegHeadFlatten``) -> a
    ``heads.SegHeadFlatten`` state dict; inverse of the JAX package's
    ``load_seg_head``."""
    p, bn = variables["params"], variables["batch_stats"]["bn"]
    sd = {"bn.weight": _t(p["bn"]["scale"]), "bn.bias": _t(p["bn"]["bias"]),
          "bn.running_mean": _t(bn["mean"]), "bn.running_var": _t(bn["var"]),
          "bn.num_batches_tracked": torch.tensor(0)}
    _lin(sd, "linear", p["linear"])
    return sd


def depth_head_state(variables) -> dict:
    """The JAX SLAM's linear ``depth_params`` -> a ``heads.DepthHeadFlatten``
    state dict; inverse of ``load_depth_head``."""
    sd = {}
    _lin(sd, "linear", variables["params"]["linear"])
    return sd


def _conv_t(sd, name, p):
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d
    weight (I, O, kh, kw), spatially flipped back (the JAX loader's
    ``_convT`` flips it)."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    sd[f"{name}.bias"] = _t(p["bias"])


def dpt_head_state(variables) -> dict:
    """The JAX SLAM's DPT ``depth_params`` (flax ``DPTHead``) -> a
    ``dpt.DPTHead`` state dict under the reference's names without
    ``decode_head.``; inverse of ``load_dpt_head``."""
    p, sd = variables["params"], {}
    ra, r = "reassemble_blocks.", p["reassemble"]
    for i in range(4):
        _lin(sd, f"{ra}readout_projects.{i}.0", r[f"readout{i}"])
        _conv(sd, f"{ra}projects.{i}.conv", r[f"project{i}"])
        _conv(sd, f"convs.{i}.conv", p[f"conv{i}"])
        fu, fb = p[f"fusion{i}"], f"fusion_blocks.{i}."
        _conv(sd, f"{fb}project.conv", fu["project"])
        for unit in ("res1", "res2")[i == 0:]:
            for c in ("conv1", "conv2"):
                _conv(sd, f"{fb}res_conv_unit{unit[-1]}.{c}.conv", fu[unit][c])
    _conv_t(sd, f"{ra}resize_layers.0", r["up4"])
    _conv_t(sd, f"{ra}resize_layers.1", r["up2"])
    _conv(sd, f"{ra}resize_layers.3", r["down2"])
    _conv(sd, "project.conv", p["project"])
    for k in (0, 2, 4):
        _conv(sd, f"conv_depth.head.{k}", p[f"head{k}"])
    return sd


# parts of a reference checkpoint that the SLAM runtime's CDVNet does not
# build (as the JAX runtime does not)
_SET_ASIDE = ("patchify.score.", "patchify.dino_adapter.")


def load_torch_checkpoint(path, version="cdv"):
    """A reference ``.pth`` -> (state dict, set aside): the state dict of
    ``CDVNet()`` ("cdv") or ``VONet()`` ("dpv"), and the score head's and
    DINO adapter's entries, which a ``CDVNet(compute_score=True,
    dino_adapt=True)`` also takes. ``module.`` prefixes are stripped and
    ``update.lmbda`` dropped, as the JAX package's loader does; a key the
    network does not hold, a key it lacks or a shape that differs raises.
    Under "dpv" the weights load by their reference names (the JAX
    converter's gated-residual swap is not reproduced)."""
    from .cdvnet import CDVNet
    from .vonet import VONet

    sd = torch.load(path, map_location="cpu")
    sd = {k.replace("module.", ""): v for k, v in sd.items() if "update.lmbda" not in k}
    aside = {}
    if version == "cdv":
        aside = {k: sd.pop(k) for k in list(sd) if k.startswith(_SET_ASIDE)}
    with torch.device("meta"):
        ref = (CDVNet() if version == "cdv" else VONet()).state_dict()
    missing, unknown = sorted(ref.keys() - sd.keys()), sorted(sd.keys() - ref.keys())
    shapes = sorted(k for k in ref.keys() & sd.keys() if ref[k].shape != sd[k].shape)
    if missing or unknown or shapes:
        raise RuntimeError(f"{path} does not fit the {version} network: missing {missing}, "
                           f"unknown {unknown}, other shapes {shapes}")
    return sd, aside
