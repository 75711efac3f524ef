"""Reference-layout checkpoints written from the port's trees.

The inverse of ``runtime/checkpoint.py``'s converters: an LM tree ->
the reference Model's state dict (torchtune qwen2 naming), a codec tree
-> the reference RedCodec "generator" state dict, and both saved as the
reference's pickles (``{"model": ...}`` in ``llm_posttrain.pt`` or
``llm_pretrain.pt``, ``{"generator": ...}`` in ``codec.pt``). The convert
drill's card run and the tests write their reference dirs with it, from
seeded weights; converting such a dir gives back the trees it was written
from. No JAX: it runs where the card is.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.runtime.checkpoint import WHISPER_LAYER_KEYS

Params = dict[str, Any]
StateDict = dict[str, torch.Tensor]


def _c(a) -> torch.Tensor:
    """A leaf (tensor or array) as a contiguous CPU tensor."""
    if torch.is_tensor(a):
        return a.detach().contiguous().cpu()
    return torch.from_numpy(np.array(a, order="C"))


def _ct(a) -> torch.Tensor:
    """A matrix leaf (in, out) as a Linear weight (out, in), transposed
    where the leaf lives (on the card, before the copy to the host)."""
    if torch.is_tensor(a):
        return _c(a.detach().T)
    return _c(np.asarray(a).T)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

_QWEN2_KEYS = {                     # tree key -> (module, transposed)
    "wq": ("attn.q_proj.weight", True), "bq": ("attn.q_proj.bias", False),
    "wk": ("attn.k_proj.weight", True), "bk": ("attn.k_proj.bias", False),
    "wv": ("attn.v_proj.weight", True), "bv": ("attn.v_proj.bias", False),
    "wo": ("attn.output_proj.weight", True),
    "w_gate": ("mlp.w1.weight", True), "w_down": ("mlp.w2.weight", True),
    "w_up": ("mlp.w3.weight", True),
    "attn_norm": ("sa_norm.scale", False), "mlp_norm": ("mlp_norm.scale", False),
}


def _qwen2_state_dict(sd: StateDict, prefix: str, tree: Params) -> None:
    for key, (module, tr) in _QWEN2_KEYS.items():
        for i in range(tree[key].shape[0]):
            leaf = tree[key][i]
            sd[f"{prefix}.layers.{i}.{module}"] = _ct(leaf) if tr else _c(leaf)
    sd[f"{prefix}.norm.scale"] = _c(tree["final_norm"])


def lm_state_dict(tree: Params) -> StateDict:
    """An LM tree -> the reference Model's state dict."""
    sd: StateDict = {}
    _qwen2_state_dict(sd, "backbone", tree["backbone"])
    _qwen2_state_dict(sd, "decoder", tree["decoder"])
    sd["text_embeddings.weight"] = _c(tree["text_embeddings"])
    sd["audio_embeddings.weight"] = _c(tree["audio_embeddings"])
    for name in ("projection", "codebook0_head", "text_head"):
        sd[f"{name}.weight"] = _ct(tree[name])
    sd["audio_head"] = _c(tree["audio_head"])
    return sd


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def _layers(sd: StateDict, prefix: str, lp: Params) -> None:
    for key, (module, param, tr) in WHISPER_LAYER_KEYS.items():
        for i in range(lp[key].shape[0]):
            leaf = lp[key][i]
            sd[f"{prefix}.{i}.{module}.{param}"] = _ct(leaf) if tr else _c(leaf)


def _conv(sd: StateDict, name: str, p: Params) -> None:
    sd[f"{name}.weight"] = _c(p["w"])
    if "b" in p:
        sd[f"{name}.bias"] = _c(p["b"])


def _encoder(sd: StateDict, prefix: str, t: Params) -> None:
    _conv(sd, f"{prefix}.conv1", t["conv1"])
    _conv(sd, f"{prefix}.conv2", t["conv2"])
    sd[f"{prefix}.embed_positions.weight"] = _c(t["pos"])
    _layers(sd, f"{prefix}.layers", t["layers"])
    sd[f"{prefix}.layer_norm.weight"] = _c(t["ln_w"])
    sd[f"{prefix}.layer_norm.bias"] = _c(t["ln_b"])


def _adaptor(sd: StateDict, prefix: str, t: Params) -> None:
    sd[f"{prefix}.in_proj.weight"] = _ct(t["in_proj_w"])
    sd[f"{prefix}.in_proj.bias"] = _c(t["in_proj_b"])
    _layers(sd, f"{prefix}.layers", t["layers"])
    sd[f"{prefix}.layer_norm.weight"] = _c(t["ln_w"])
    sd[f"{prefix}.layer_norm.bias"] = _c(t["ln_b"])
    sd[f"{prefix}.out_proj.weight"] = _ct(t["out_proj_w"])
    sd[f"{prefix}.out_proj.bias"] = _c(t["out_proj_b"])


def _resnet(sd: StateDict, prefix: str, t: Params) -> None:
    """The causal block ([Transpose, LN, Transpose, SiLU, CausalConv]) or
    the non-causal one ([GroupNorm, SiLU, Conv]), by the tree's keys."""
    if "ln1_w" in t:
        norms, convs = ("block1.1", "block2.1"), ("block1.4", "block2.5")
        keys = ("ln1", "ln2")
    else:
        norms, convs = ("block1.0", "block2.0"), ("block1.2", "block2.3")
        keys = ("gn1", "gn2")
    for norm, key in zip(norms, keys):
        sd[f"{prefix}.{norm}.weight"] = _c(t[f"{key}_w"])
        sd[f"{prefix}.{norm}.bias"] = _c(t[f"{key}_b"])
    _conv(sd, f"{prefix}.{convs[0]}", t["conv1"])
    _conv(sd, f"{prefix}.{convs[1]}", t["conv2"])


def _wn_conv(sd: StateDict, name: str, w, b, form: str,
             rng: Optional[np.random.Generator]) -> None:
    """An (in, out) matrix as a 1x1 conv weight (out, in, 1): plain
    ("weight"), or as a weight-norm parametrization ("wn": a random g in
    [0.5, 1.5) and v = the matrix, which the converters fold to g·v/|v|)."""
    conv = _c(w).to(torch.float32).T.contiguous()[:, :, None]
    if form == "weight":
        sd[f"{name}.weight"] = conv
    else:
        pre = f"{name}.parametrizations.weight"
        sd[f"{pre}.original0"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, (conv.shape[0], 1, 1)).astype(np.float32))
        sd[f"{pre}.original1"] = conv
    sd[f"{name}.bias"] = _c(b)


def codec_state_dict(tree: Params, form: str = "weight",
                     rng: Optional[np.random.Generator] = None) -> StateDict:
    """A codec tree (with its "semantic_decoder") -> the reference RedCodec
    state dict; the RVQ's 1x1 projections in `form` ("weight" or "wn",
    which needs `rng`)."""
    sd: StateDict = {}
    _encoder(sd, "ssl", tree["ssl"])
    _adaptor(sd, "ssl_adaptor", tree["ssl_adaptor"])
    _encoder(sd, "acoustic_encoder", tree["acoustic_encoder"])
    ds = tree["downsample"]
    sd["downsample.gate_proj.weight"] = _c(ds["gate_w"])
    sd["downsample.up_proj.weight"] = _c(ds["up_w"])
    sd["downsample.down_proj.weight"] = _ct(ds["down_w"])
    sd["downsample.layer_norm.weight"] = _c(ds["ln_w"])
    sd["downsample.layer_norm.bias"] = _c(ds["ln_b"])
    sd["downsample.out_proj.weight"] = _ct(ds["out_w"])
    sd["downsample.out_proj.bias"] = _c(ds["out_b"])
    rvq = tree["rvq"]
    for i in range(rvq["codebook"].shape[0]):
        q = f"rvq.quantizers.{i}"
        sd[f"{q}.codebook"] = _c(rvq["codebook"][i])
        _wn_conv(sd, f"{q}.in_project", rvq["in_proj_w"][i],
                 rvq["in_proj_b"][i], form, rng)
        _wn_conv(sd, f"{q}.out_project", rvq["out_proj_w"][i],
                 rvq["out_proj_b"][i], form, rng)
    for key, name in (("input_proj", "rvq.input_proj"),
                      ("output_proj", "rvq.output_proj")):
        if f"{key}_w" in rvq:
            _wn_conv(sd, name, rvq[f"{key}_w"], rvq[f"{key}_b"], form, rng)
    up = tree["upsample"]
    sd["upsample.in_proj.weight"] = _ct(up["in_proj_w"])
    sd["upsample.in_proj.bias"] = _c(up["in_proj_b"])
    sd["upsample.up_conv.weight"] = _c(up["up_conv_w"])
    _adaptor(sd, "semantic_decoder", tree["semantic_decoder"])
    ad = tree["acoustic_decoder"]
    for j, n in (("0", "up1"), ("2", "up2")):
        sd[f"acoustic_decoder.upsample_conv.{j}.weight"] = _c(ad[f"{n}_w"])
        sd[f"acoustic_decoder.upsample_conv.{j}.bias"] = _c(ad[f"{n}_b"])
    bb = "acoustic_decoder.backbone"
    _conv(sd, f"{bb}.in_proj", ad["in_proj"])
    for name, key in (("prior_net.0", "prior0"), ("prior_net.1", "prior1"),
                      ("post_net.0", "post0"), ("post_net.1", "post1")):
        _resnet(sd, f"{bb}.{name}", ad[key])
    _layers(sd, f"{bb}.transformers", ad["layers"])
    sd[f"{bb}.final_norm.weight"] = _c(ad["final_ln_w"])
    sd[f"{bb}.final_norm.bias"] = _c(ad["final_ln_b"])
    sd["acoustic_decoder.isift.out.weight"] = _ct(ad["head_w"])
    sd["acoustic_decoder.isift.out.bias"] = _c(ad["head_b"])
    return sd


def write_reference_pickles(d: str, lm: Optional[Params] = None,
                            codec: Optional[Params] = None,
                            lm_name: str = "llm_posttrain.pt") -> list[str]:
    """Save the reference pickles of the given trees into `d`: the LM's
    as `lm_name`, the codec's as ``codec.pt``. Returns the paths written."""
    os.makedirs(d, exist_ok=True)
    written = []
    for tree, name, key, fn in ((lm, lm_name, "model", lm_state_dict),
                                (codec, "codec.pt", "generator",
                                 codec_state_dict)):
        if tree is not None:
            path = os.path.join(d, name)
            torch.save({key: fn(tree)}, path)
            written.append(path)
    return written
