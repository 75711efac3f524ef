"""Reference checkpoints -> the port's parameter trees, and the converted
trees' own save and load.

Counterpart of ``fireredtts2_tpu/runtime/checkpoint.py``. The reference
ships torch pickles: {"model": state_dict} for the LM (torchtune qwen2
naming) and {"generator": state_dict} for the codec (the reference's own
module names). The converters map them onto the stacked trees both
packages use, with the JAX package's conventions:
- Linear weights (out, in) -> (in, out);
- per-layer weights stacked onto a leading L axis;
- weight-normed 1x1 convs (the RVQ projections) folded into plain
  matrices, W = g * v / ||v||, from either the ``.weight`` or the
  ``parametrizations.weight.original0/1`` form;
- q/k weights copied as they are (both use the half-split RoPE).
The arithmetic runs in numpy, as the JAX package's does, so both give the
same trees; the codec's RVQ subtree and mel filterbank stay float32.

``save_params`` / ``load_params`` store a converted tree with
``torch.save`` under ``DIR/torch/<name>.pt`` (the JAX package keeps Orbax
trees under ``DIR/jax/``), so a pickle is read and converted once.
A local HF whisper checkout (the SSL encoder, when ``codec.pt`` has none)
is read from ``model.safetensors`` by this module's own reader, or from
``pytorch_model.bin``; ``write_safetensors`` writes such a file (neither
needs the ``safetensors`` package).
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from fireredtts2_tpu_torch.config import (
    CodecConfig, LLMConfig, SslAdaptorConfig, TransformerConfig,
    WhisperEncoderConfig,
)
from fireredtts2_tpu_torch.ops.audio import whisper_mel_filters

Params = dict[str, Any]


def _t(x) -> np.ndarray:
    """A state-dict entry as numpy (half types widened to float32)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _arr(a: np.ndarray, dtype) -> torch.Tensor:
    """numpy -> a contiguous tensor of `dtype`; float64 goes through
    float32 first, as the JAX package's jnp.asarray takes it (64-bit off).
    A transposed view is cast first and laid out by torch's copy, which
    is several times faster than numpy's for large matrices."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(dtype).contiguous()


def _leaf(sd: Mapping, key: str, dtype) -> torch.Tensor:
    return _arr(_t(sd[key]), dtype)


def _lin(sd: Mapping, name: str) -> np.ndarray:
    """Linear weight (out, in) -> (in, out)."""
    return _t(sd[f"{name}.weight"]).T


def _wn_conv1x1(sd: Mapping, name: str) -> tuple[np.ndarray, np.ndarray]:
    """Weight-normed 1x1 Conv1d -> ((in, out) matrix, (out,) bias).

    The parametrized form stores g (original0, (out, 1, 1)) and v
    (original1, (out, in, 1)); W = g * v / ||v|| over all but dim 0. A
    plain checkpoint may store the weight itself."""
    if f"{name}.weight" in sd:
        w = _t(sd[f"{name}.weight"])
    else:
        g = _t(sd[f"{name}.parametrizations.weight.original0"])
        v = _t(sd[f"{name}.parametrizations.weight.original1"])
        norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)),
                                    keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    b = _t(sd[f"{name}.bias"]) if f"{name}.bias" in sd else np.zeros(w.shape[0])
    return w[:, :, 0].T, b


def _stack(arrs: list[np.ndarray], dtype) -> torch.Tensor:
    return torch.stack([_arr(a, dtype) for a in arrs])


# ---------------------------------------------------------------------------
# LM (torchtune qwen2 naming)
# ---------------------------------------------------------------------------


def convert_qwen2_transformer(sd: Mapping, prefix: str, cfg: TransformerConfig,
                              dtype=torch.bfloat16) -> Params:
    """torchtune qwen2 TransformerDecoder state dict -> stacked tree.

    Per layer: {prefix}.layers.{i}.attn.{q,k,v}_proj.{weight,bias},
    attn.output_proj.weight, mlp.w1/w2/w3.weight (gate/down/up),
    sa_norm.scale, mlp_norm.scale; then {prefix}.norm.scale. Missing
    q/k/v biases are zeros."""
    L = cfg.num_layers

    def per_layer(fmt: str, transpose: bool = True) -> list[np.ndarray]:
        out = []
        for i in range(L):
            w = _t(sd[fmt.format(prefix=prefix, i=i)])
            out.append(w.T if transpose else w)
        return out

    params = {
        "wq": _stack(per_layer("{prefix}.layers.{i}.attn.q_proj.weight"), dtype),
        "wk": _stack(per_layer("{prefix}.layers.{i}.attn.k_proj.weight"), dtype),
        "wv": _stack(per_layer("{prefix}.layers.{i}.attn.v_proj.weight"), dtype),
        "wo": _stack(per_layer("{prefix}.layers.{i}.attn.output_proj.weight"),
                     dtype),
        "w_gate": _stack(per_layer("{prefix}.layers.{i}.mlp.w1.weight"), dtype),
        "w_down": _stack(per_layer("{prefix}.layers.{i}.mlp.w2.weight"), dtype),
        "w_up": _stack(per_layer("{prefix}.layers.{i}.mlp.w3.weight"), dtype),
        "attn_norm": _stack(per_layer("{prefix}.layers.{i}.sa_norm.scale",
                                      False), dtype),
        "mlp_norm": _stack(per_layer("{prefix}.layers.{i}.mlp_norm.scale",
                                     False), dtype),
        "final_norm": _leaf(sd, f"{prefix}.norm.scale", dtype),
    }
    for name, key in (("q_proj", "bq"), ("k_proj", "bk"), ("v_proj", "bv")):
        if f"{prefix}.layers.0.attn.{name}.bias" in sd:
            params[key] = _stack(per_layer(
                "{prefix}.layers.{i}.attn." + name + ".bias", False), dtype)
        else:
            heads = cfg.num_heads if key == "bq" else cfg.num_kv_heads
            params[key] = torch.zeros((L, heads * cfg.head_dim), dtype=dtype)
    return params


def convert_lm_state_dict(sd: Mapping, cfg: LLMConfig,
                          dtype=torch.bfloat16) -> Params:
    """The reference Model's state dict -> the LM tree."""
    return {
        "backbone": convert_qwen2_transformer(sd, "backbone", cfg.backbone,
                                              dtype),
        "decoder": convert_qwen2_transformer(sd, "decoder", cfg.decoder, dtype),
        "text_embeddings": _leaf(sd, "text_embeddings.weight", dtype),
        "audio_embeddings": _leaf(sd, "audio_embeddings.weight", dtype),
        "projection": _arr(_lin(sd, "projection"), dtype),
        "codebook0_head": _arr(_lin(sd, "codebook0_head"), dtype),
        "text_head": _arr(_lin(sd, "text_head"), dtype),
        "audio_head": _leaf(sd, "audio_head", dtype),
    }


# ---------------------------------------------------------------------------
# Codec (the reference's module naming)
# ---------------------------------------------------------------------------


def _conv1d_params(sd: Mapping, name: str, dtype) -> Params:
    p = {"w": _leaf(sd, f"{name}.weight", dtype)}
    if f"{name}.bias" in sd:
        p["b"] = _leaf(sd, f"{name}.bias", dtype)
    return p


# whisper layer tree key -> (the reference's / HF's module under
# {prefix}.{i}, its parameter, transposed: a Linear weight (out, in) ->
# (in, out))
WHISPER_LAYER_KEYS = {
    "wq": ("self_attn.q_proj", "weight", True),
    "bq": ("self_attn.q_proj", "bias", False),
    "wk": ("self_attn.k_proj", "weight", True),
    "wv": ("self_attn.v_proj", "weight", True),
    "bv": ("self_attn.v_proj", "bias", False),
    "wo": ("self_attn.out_proj", "weight", True),
    "bo": ("self_attn.out_proj", "bias", False),
    "attn_ln_w": ("self_attn_layer_norm", "weight", False),
    "attn_ln_b": ("self_attn_layer_norm", "bias", False),
    "fc1_w": ("fc1", "weight", True),
    "fc1_b": ("fc1", "bias", False),
    "fc2_w": ("fc2", "weight", True),
    "fc2_b": ("fc2", "bias", False),
    "ffn_ln_w": ("final_layer_norm", "weight", False),
    "ffn_ln_b": ("final_layer_norm", "bias", False),
}


def convert_stacked_layers(sd: Mapping, prefix: str, L: int, keys: Mapping,
                           dtype) -> Params:
    """{tree key: (module, parameter, transposed)} -> each key's L layers
    of ``{prefix}.{i}.{module}.{parameter}`` stacked."""
    def stacked(module: str, param: str, transpose: bool) -> torch.Tensor:
        arrs = [_t(sd[f"{prefix}.{i}.{module}.{param}"]) for i in range(L)]
        return _stack([a.T for a in arrs] if transpose else arrs, dtype)

    return {k: stacked(*v) for k, v in keys.items()}


def _convert_whisper_encoder(sd: Mapping, prefix: str,
                             cfg: WhisperEncoderConfig, dtype) -> Params:
    return {
        "conv1": _conv1d_params(sd, f"{prefix}.conv1", dtype),
        "conv2": _conv1d_params(sd, f"{prefix}.conv2", dtype),
        "pos": _leaf(sd, f"{prefix}.embed_positions.weight", dtype),
        "layers": convert_stacked_layers(sd, f"{prefix}.layers",
                                         cfg.num_layers, WHISPER_LAYER_KEYS,
                                         dtype),
        "ln_w": _leaf(sd, f"{prefix}.layer_norm.weight", dtype),
        "ln_b": _leaf(sd, f"{prefix}.layer_norm.bias", dtype),
    }


def _convert_ssl_adaptor(sd: Mapping, prefix: str, cfg: SslAdaptorConfig,
                         dtype) -> Params:
    return {
        "in_proj_w": _arr(_lin(sd, f"{prefix}.in_proj"), dtype),
        "in_proj_b": _leaf(sd, f"{prefix}.in_proj.bias", dtype),
        "layers": convert_stacked_layers(sd, f"{prefix}.layers",
                                         cfg.num_layers, WHISPER_LAYER_KEYS,
                                         dtype),
        "ln_w": _leaf(sd, f"{prefix}.layer_norm.weight", dtype),
        "ln_b": _leaf(sd, f"{prefix}.layer_norm.bias", dtype),
        "out_proj_w": _arr(_lin(sd, f"{prefix}.out_proj"), dtype),
        "out_proj_b": _leaf(sd, f"{prefix}.out_proj.bias", dtype),
    }


def _has_conv(sd: Mapping, name: str) -> bool:
    return (f"{name}.parametrizations.weight.original0" in sd
            or f"{name}.weight" in sd)


def _convert_rvq(sd: Mapping, cfg) -> Params:
    """The RVQ subtree, float32 whatever the codec's dtype. A quantizer
    without an in/out projection (equal dims) gets the identity."""
    f32 = torch.float32
    rd = cfg.resolved_rvq_dim
    cbs, ins, ibs, outs, obs = [], [], [], [], []
    for i in range(cfg.num_quantizers):
        q = f"rvq.quantizers.{i}"
        cbs.append(_t(sd[f"{q}.codebook"]))
        for proj, ws, bs in (("in_project", ins, ibs),
                             ("out_project", outs, obs)):
            if _has_conv(sd, f"{q}.{proj}"):
                w, b = _wn_conv1x1(sd, f"{q}.{proj}")
            else:
                w, b = np.eye(rd), np.zeros(rd)
            ws.append(w)
            bs.append(b)
    p: Params = {
        "codebook": _stack(cbs, f32), "in_proj_w": _stack(ins, f32),
        "in_proj_b": _stack(ibs, f32), "out_proj_w": _stack(outs, f32),
        "out_proj_b": _stack(obs, f32),
    }
    if cfg.input_dim != rd:
        w, b = _wn_conv1x1(sd, "rvq.input_proj")
        p["input_proj_w"], p["input_proj_b"] = _arr(w, f32), _arr(b, f32)
    if cfg.resolved_output_dim != rd:
        w, b = _wn_conv1x1(sd, "rvq.output_proj")
        p["output_proj_w"], p["output_proj_b"] = _arr(w, f32), _arr(b, f32)
    return p


def _convert_resnet(sd: Mapping, prefix: str, dtype) -> Params:
    """Non-causal ResnetBlock: block1 = [GroupNorm, SiLU, Conv]; block2 =
    [GroupNorm, SiLU, Dropout, Conv]."""
    return {
        "gn1_w": _leaf(sd, f"{prefix}.block1.0.weight", dtype),
        "gn1_b": _leaf(sd, f"{prefix}.block1.0.bias", dtype),
        "conv1": _conv1d_params(sd, f"{prefix}.block1.2", dtype),
        "gn2_w": _leaf(sd, f"{prefix}.block2.0.weight", dtype),
        "gn2_b": _leaf(sd, f"{prefix}.block2.0.bias", dtype),
        "conv2": _conv1d_params(sd, f"{prefix}.block2.3", dtype),
    }


def _convert_causal_resnet(sd: Mapping, prefix: str, dtype) -> Params:
    """CausalResnetBlock: block1 = [Transpose, LN, Transpose, SiLU,
    CausalConv]; block2 = [..., Dropout, CausalConv]."""
    return {
        "ln1_w": _leaf(sd, f"{prefix}.block1.1.weight", dtype),
        "ln1_b": _leaf(sd, f"{prefix}.block1.1.bias", dtype),
        "conv1": _conv1d_params(sd, f"{prefix}.block1.4", dtype),
        "ln2_w": _leaf(sd, f"{prefix}.block2.1.weight", dtype),
        "ln2_b": _leaf(sd, f"{prefix}.block2.1.bias", dtype),
        "conv2": _conv1d_params(sd, f"{prefix}.block2.5", dtype),
    }


def convert_codec_state_dict(sd: Mapping, cfg: CodecConfig,
                             dtype=torch.float32) -> Params:
    """The reference RedCodec "generator" state dict -> the codec tree
    (the JAX package's, ``semantic_decoder`` included)."""
    ad = cfg.acoustic_decoder
    resnet = _convert_causal_resnet if ad.causal else _convert_resnet
    bb = "acoustic_decoder.backbone"
    m = cfg.mel
    return {
        "ssl": _convert_whisper_encoder(sd, "ssl", cfg.ssl, dtype),
        "ssl_adaptor": _convert_ssl_adaptor(sd, "ssl_adaptor", cfg.ssl_adaptor,
                                            dtype),
        "acoustic_encoder": _convert_whisper_encoder(
            sd, "acoustic_encoder", cfg.acoustic_encoder, dtype),
        "downsample": {
            "gate_w": _leaf(sd, "downsample.gate_proj.weight", dtype),
            "up_w": _leaf(sd, "downsample.up_proj.weight", dtype),
            "down_w": _arr(_lin(sd, "downsample.down_proj"), dtype),
            "ln_w": _leaf(sd, "downsample.layer_norm.weight", dtype),
            "ln_b": _leaf(sd, "downsample.layer_norm.bias", dtype),
            "out_w": _arr(_lin(sd, "downsample.out_proj"), dtype),
            "out_b": _leaf(sd, "downsample.out_proj.bias", dtype),
        },
        "rvq": _convert_rvq(sd, cfg.rvq),
        "upsample": {
            "in_proj_w": _arr(_lin(sd, "upsample.in_proj"), dtype),
            "in_proj_b": _leaf(sd, "upsample.in_proj.bias", dtype),
            "up_conv_w": _leaf(sd, "upsample.up_conv.weight", dtype),
        },
        "semantic_decoder": _convert_ssl_adaptor(
            sd, "semantic_decoder", cfg.semantic_decoder, dtype),
        "acoustic_decoder": {
            "up1_w": _leaf(sd, "acoustic_decoder.upsample_conv.0.weight", dtype),
            "up1_b": _leaf(sd, "acoustic_decoder.upsample_conv.0.bias", dtype),
            "up2_w": _leaf(sd, "acoustic_decoder.upsample_conv.2.weight", dtype),
            "up2_b": _leaf(sd, "acoustic_decoder.upsample_conv.2.bias", dtype),
            "in_proj": _conv1d_params(sd, f"{bb}.in_proj", dtype),
            "prior0": resnet(sd, f"{bb}.prior_net.0", dtype),
            "prior1": resnet(sd, f"{bb}.prior_net.1", dtype),
            "layers": convert_stacked_layers(sd, f"{bb}.transformers",
                                             ad.num_layers, WHISPER_LAYER_KEYS,
                                             dtype),
            "post0": resnet(sd, f"{bb}.post_net.0", dtype),
            "post1": resnet(sd, f"{bb}.post_net.1", dtype),
            "final_ln_w": _leaf(sd, f"{bb}.final_norm.weight", dtype),
            "final_ln_b": _leaf(sd, f"{bb}.final_norm.bias", dtype),
            "head_w": _arr(_lin(sd, "acoustic_decoder.isift.out"), dtype),
            "head_b": _leaf(sd, "acoustic_decoder.isift.out.bias", dtype),
        },
        "mel_filters": torch.from_numpy(whisper_mel_filters(
            m.num_mels, m.n_fft, m.sampling_rate, m.fmin, m.fmax)),
    }


# ---------------------------------------------------------------------------
# Loading entry points
# ---------------------------------------------------------------------------


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def load_lm_checkpoint(path: str, cfg: LLMConfig, dtype=torch.bfloat16,
                       device=None) -> Params:
    """The reference LM pickle ({"model": state_dict}) -> the LM tree."""
    sd = torch.load(path, map_location="cpu", weights_only=False)["model"]
    return _to(convert_lm_state_dict(sd, cfg, dtype), device)


def load_codec_checkpoint(path: str, cfg: CodecConfig, dtype=torch.float32,
                          hf_whisper_dir: Optional[str] = None,
                          device=None) -> Params:
    """The reference codec pickle ({"generator": state_dict}) -> the codec
    tree. When the pickle has no ``ssl.*`` entries the SSL encoder (the
    reference pulls whisper-large-v3's) comes from a local HF whisper
    checkout; without one this raises FileNotFoundError."""
    sd = torch.load(path, map_location="cpu", weights_only=False)["generator"]
    if not any(k.startswith("ssl.conv1") for k in sd):
        if hf_whisper_dir is None:
            raise FileNotFoundError(
                "codec checkpoint has no ssl.* weights; pass hf_whisper_dir "
                "(a local openai/whisper-large-v3 checkout)")
        sd = dict(sd)
        sd.update(load_hf_whisper_encoder_sd(hf_whisper_dir, prefix="ssl"))
    return _to(convert_codec_state_dict(sd, cfg, dtype), device)


_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header of each tensor's dtype,
    shape and [start, end) byte offsets into the data that follows, then
    the raw little-endian data."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        item = torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(data, dtype=dtype,
                                     count=(end - start) // item,
                                     offset=start).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """{name: tensor} -> a ``.safetensors`` file that
    :func:`read_safetensors` (and the ``safetensors`` package) reads: the
    header's JSON padded with spaces to a multiple of 8 bytes, then each
    tensor's raw little-endian bytes in order."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1)
                        .view(torch.uint8).numpy())


def load_hf_whisper_encoder_sd(model_dir: str, prefix: str = "ssl") -> dict:
    """A local HF whisper checkout -> reference-style ``{prefix}.*``
    encoder entries (HF's 'model.encoder.X' / 'encoder.X' -> '{prefix}.X';
    the tensors' layouts are already the reference's)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        sd = read_safetensors(st_path)
    else:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        for p in ("model.encoder.", "encoder."):
            if k.startswith(p):
                out[f"{prefix}." + k[len(p):]] = v
                break
    if not out:
        raise ValueError(f"no encoder.* tensors found in {model_dir}")
    return out


def find_hf_whisper_dir(pretrained_dir: str) -> Optional[str]:
    """A local HF whisper checkout inside a pretrained dir (a subdirectory
    whose config.json says model_type "whisper"), or None."""
    for name in sorted(os.listdir(pretrained_dir)):
        sub = os.path.join(pretrained_dir, name)
        cfg_path = os.path.join(sub, "config.json")
        if os.path.isdir(sub) and os.path.exists(cfg_path):
            try:
                with open(cfg_path) as f:
                    if json.load(f).get("model_type") == "whisper":
                        return sub
            except (ValueError, OSError):
                continue
    return None


# ---------------------------------------------------------------------------
# Converted trees: DIR/torch/<name>.pt
# ---------------------------------------------------------------------------


def converted_path(pretrained_dir: str, name: str) -> str:
    """Where a converted tree of `name` ("llm_posttrain", "llm_pretrain",
    "codec") lives in a serving dir."""
    return os.path.join(pretrained_dir, "torch", f"{name}.pt")


def save_params(path: str, params: Params) -> None:
    """Persist a converted tree (nested dicts of tensors) with torch.save."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(params, path)


def load_params(path: str, device=None) -> Params:
    """A tree saved by :func:`save_params`, its tensors on `device`."""
    return torch.load(path, map_location=device or "cpu", weights_only=True)


def _cast_floats(tree: Any, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def load_converted_lm(path: str, dtype=torch.bfloat16, device=None) -> Params:
    """A saved LM tree with its float leaves cast to `dtype` (the
    conversion is one dtype throughout, so this equals
    load_lm_checkpoint's tree when the dtypes agree)."""
    return _cast_floats(load_params(path, device), dtype)


def load_converted_codec(path: str, dtype=torch.float32,
                         device=None) -> Params:
    """A saved codec tree under convert_codec_state_dict's dtype policy:
    float leaves to `dtype`, except the RVQ subtree and the mel
    filterbank, which stay float32."""
    tree = load_params(path, device)
    return {k: (v if k in ("rvq", "mel_filters") else _cast_floats(v, dtype))
            for k, v in tree.items()}
