"""HF Whisper checkpoints <-> the ASR parameter tree.

Counterpart of ``fireredtts2_tpu/asr/convert.py``: an HF
``WhisperForConditionalGeneration`` (or plain ``WhisperModel``) state dict
becomes the ``asr/model.py`` tree, with the layer converters of
``runtime/checkpoint.py`` (HF's whisper naming is the reference codec's).
``load_hf_whisper`` reads a local checkpoint dir: ``config.json`` and
``model.safetensors`` (the port's own reader) or ``pytorch_model.bin``
(``torch.load`` with ``weights_only``); it needs neither ``safetensors``
nor ``transformers``.

``hf_whisper_state_dict`` and ``write_hf_whisper_dir`` go the other way:
a tree and its config -> an HF-format dir that both packages' loaders
read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from fireredtts2_tpu_torch.asr.model import WhisperASRModelConfig
from fireredtts2_tpu_torch.runtime.checkpoint import (
    WHISPER_LAYER_KEYS, _conv1d_params, _leaf, _to,
    convert_stacked_layers, read_safetensors, write_safetensors,
)

Params = dict[str, Any]


def _strip_prefix(sd: Mapping, prefix: str = "model.") -> dict:
    """HF WhisperForConditionalGeneration prepends 'model.'; WhisperModel
    does not. Accept both."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return dict(sd)


def convert_hf_whisper_encoder(sd: Mapping, num_layers: int,
                               dtype=torch.float32) -> Params:
    """HF whisper state dict -> the whisper_nn encoder tree (conv front
    end, positions, stacked layers, final norm)."""
    sd = _strip_prefix(sd)
    return {
        "conv1": _conv1d_params(sd, "encoder.conv1", dtype),
        "conv2": _conv1d_params(sd, "encoder.conv2", dtype),
        "pos": _leaf(sd, "encoder.embed_positions.weight", dtype),
        "layers": convert_stacked_layers(sd, "encoder.layers", num_layers,
                                         WHISPER_LAYER_KEYS, dtype),
        "ln_w": _leaf(sd, "encoder.layer_norm.weight", dtype),
        "ln_b": _leaf(sd, "encoder.layer_norm.bias", dtype),
    }


# decoder tree key -> (HF module under decoder.layers.{i}, parameter,
# transposed); the encoder's are runtime/checkpoint.py's WHISPER_LAYER_KEYS
_DECODER_KEYS = {
    "self_wq": ("self_attn.q_proj", "weight", True),
    "self_bq": ("self_attn.q_proj", "bias", False),
    "self_wk": ("self_attn.k_proj", "weight", True),
    "self_wv": ("self_attn.v_proj", "weight", True),
    "self_bv": ("self_attn.v_proj", "bias", False),
    "self_wo": ("self_attn.out_proj", "weight", True),
    "self_bo": ("self_attn.out_proj", "bias", False),
    "self_ln_w": ("self_attn_layer_norm", "weight", False),
    "self_ln_b": ("self_attn_layer_norm", "bias", False),
    "cross_wq": ("encoder_attn.q_proj", "weight", True),
    "cross_bq": ("encoder_attn.q_proj", "bias", False),
    "cross_wk": ("encoder_attn.k_proj", "weight", True),
    "cross_wv": ("encoder_attn.v_proj", "weight", True),
    "cross_bv": ("encoder_attn.v_proj", "bias", False),
    "cross_wo": ("encoder_attn.out_proj", "weight", True),
    "cross_bo": ("encoder_attn.out_proj", "bias", False),
    "cross_ln_w": ("encoder_attn_layer_norm", "weight", False),
    "cross_ln_b": ("encoder_attn_layer_norm", "bias", False),
    "fc1_w": ("fc1", "weight", True),
    "fc1_b": ("fc1", "bias", False),
    "fc2_w": ("fc2", "weight", True),
    "fc2_b": ("fc2", "bias", False),
    "ffn_ln_w": ("final_layer_norm", "weight", False),
    "ffn_ln_b": ("final_layer_norm", "bias", False),
}


def _convert_decoder_layers(sd: Mapping, L: int, dtype) -> Params:
    return convert_stacked_layers(sd, "decoder.layers", L, _DECODER_KEYS,
                                  dtype)


def convert_hf_whisper(sd: Mapping, cfg: WhisperASRModelConfig,
                       dtype=torch.float32) -> Params:
    """A whole HF whisper state dict -> the asr/model.py tree."""
    sd = _strip_prefix(sd)
    return {
        "encoder": convert_hf_whisper_encoder(sd, cfg.encoder_layers, dtype),
        "decoder": {
            "layers": _convert_decoder_layers(sd, cfg.decoder_layers, dtype),
            "token_emb": _leaf(sd, "decoder.embed_tokens.weight", dtype),
            "pos_emb": _leaf(sd, "decoder.embed_positions.weight", dtype),
            "ln_w": _leaf(sd, "decoder.layer_norm.weight", dtype),
            "ln_b": _leaf(sd, "decoder.layer_norm.bias", dtype),
        },
    }


def asr_config_from_hf(hf_config) -> WhisperASRModelConfig:
    """An HF WhisperConfig (or any object with its attribute names) ->
    WhisperASRModelConfig: dims, SOT and EOT; the other special tokens
    keep large-v3's ids."""
    return WhisperASRModelConfig(
        n_mels=hf_config.num_mel_bins,
        vocab_size=hf_config.vocab_size,
        encoder_layers=hf_config.encoder_layers,
        decoder_layers=hf_config.decoder_layers,
        num_heads=hf_config.encoder_attention_heads,
        embed_dim=hf_config.d_model,
        ffn_dim=hf_config.encoder_ffn_dim,
        max_source_positions=hf_config.max_source_positions,
        max_target_positions=hf_config.max_target_positions,
        sot_id=hf_config.decoder_start_token_id,
        eot_id=hf_config.eos_token_id,
    )


class _HFConfig:
    """config.json's fields as attributes (a missing one reads None)."""

    def __init__(self, d: dict):
        self.__dict__.update(d)

    def __getattr__(self, k):
        return None


def load_hf_whisper(model_dir: str, dtype=torch.float32, device=None
                    ) -> tuple[Params, WhisperASRModelConfig]:
    """A local HF whisper checkpoint dir (config.json and model.safetensors
    or pytorch_model.bin) -> (the tree on `device`, its config). Reads
    local files only."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = asr_config_from_hf(_HFConfig(json.load(f)))
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        sd = read_safetensors(st_path)
    else:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    params = convert_hf_whisper(sd, cfg, dtype)
    if device is not None:
        params = _to(params, device)
    return params, cfg


def hf_whisper_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """The inverse of :func:`convert_hf_whisper` on a float tree: HF
    ``WhisperForConditionalGeneration`` names ('model.' prefixed)."""
    sd: dict[str, torch.Tensor] = {}
    enc, dec = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        sd[f"model.encoder.{conv}.weight"] = enc[conv]["w"]
        sd[f"model.encoder.{conv}.bias"] = enc[conv]["b"]
    sd["model.encoder.embed_positions.weight"] = enc["pos"]
    for side, tree, keys in (("encoder", enc["layers"], WHISPER_LAYER_KEYS),
                             ("decoder", dec["layers"], _DECODER_KEYS)):
        for key, (module, param, transpose) in keys.items():
            for i, t in enumerate(tree[key].unbind(0)):
                sd[f"model.{side}.layers.{i}.{module}.{param}"] = (
                    t.t() if transpose else t).contiguous()
    sd["model.encoder.layer_norm.weight"] = enc["ln_w"]
    sd["model.encoder.layer_norm.bias"] = enc["ln_b"]
    sd["model.decoder.embed_tokens.weight"] = dec["token_emb"]
    sd["model.decoder.embed_positions.weight"] = dec["pos_emb"]
    sd["model.decoder.layer_norm.weight"] = dec["ln_w"]
    sd["model.decoder.layer_norm.bias"] = dec["ln_b"]
    return sd


def write_hf_whisper_dir(d: str, params: Params,
                         cfg: WhisperASRModelConfig) -> None:
    """An HF-format whisper dir: config.json (the fields
    :func:`asr_config_from_hf` reads) and model.safetensors."""
    os.makedirs(d, exist_ok=True)
    hf = {"model_type": "whisper", "num_mel_bins": cfg.n_mels,
          "vocab_size": cfg.vocab_size, "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.decoder_layers,
          "encoder_attention_heads": cfg.num_heads,
          "decoder_attention_heads": cfg.num_heads, "d_model": cfg.embed_dim,
          "encoder_ffn_dim": cfg.ffn_dim, "decoder_ffn_dim": cfg.ffn_dim,
          "max_source_positions": cfg.max_source_positions,
          "max_target_positions": cfg.max_target_positions,
          "decoder_start_token_id": cfg.sot_id, "eos_token_id": cfg.eot_id}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    write_safetensors(os.path.join(d, "model.safetensors"),
                      hf_whisper_state_dict(params))
