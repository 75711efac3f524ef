"""Conversation-LLM backends behind the Responder protocol.

Counterpart of ``fireredtts2_tpu/serve/llm.py``. Capability parity with
the reference's LLM manager
(conversation_llm.py:60-117 LocalLLM over HF transformers, :270-434
OpenAILLM, :559-679 ConversationLLMManager with primary->fallback order).
Differences driven by this stack's constraints:

- the HF backend loads LOCAL checkpoints only (zero-egress environment;
  pass a directory, e.g. a DialoGPT-class causal LM saved with
  save_pretrained) and runs on CPU torch — the card is reserved for the
  TTS/ASR models; ``transformers`` is imported only when it loads, so the
  module imports without it;
- the OpenAI backend speaks the chat-completions HTTP protocol with the
  stdlib (no `openai` package in this image), so it works against any
  OpenAI-compatible endpoint (vLLM, llama.cpp, a gateway);
- both satisfy serve/s2s.py's `Responder` protocol and compose with the
  existing `ResponderChain`, which implements the reference's fallback
  semantics.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Optional

from fireredtts2_tpu_torch.serve.s2s import (
    Responder, ResponderChain, RuleBasedResponder,
)


DEFAULT_SYSTEM_PROMPT = (
    "You are a helpful voice assistant. Keep replies short, conversational, "
    "and speakable — no markdown, no lists."
)


class HFCausalLMResponder:
    """Local HF causal-LM chat backend (reference LocalLLM,
    conversation_llm.py:60-268), loaded lazily from a local directory."""

    def __init__(self, model_dir: str, max_new_tokens: int = 60,
                 temperature: float = 0.8, top_p: float = 0.9,
                 max_history_turns: int = 6, greedy: bool = False,
                 seed: Optional[int] = 0):
        self.model_dir = model_dir
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.max_history_turns = max_history_turns
        self.greedy = greedy
        self.seed = seed
        self._model = None
        self._tokenizer = None
        self.total_generations = 0
        self.total_processing_time_ms = 0.0

    def _load(self):
        if self._model is not None:
            return
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(
            self.model_dir, local_files_only=True)
        if self._tokenizer.pad_token is None:
            self._tokenizer.pad_token = self._tokenizer.eos_token
        self._model = AutoModelForCausalLM.from_pretrained(
            self.model_dir, local_files_only=True,
            torch_dtype=torch.float32).eval()

    def _format(self, text: str, history: list[tuple[str, str]]) -> str:
        """DialoGPT-style turn concatenation with EOS separators
        (conversation_llm.py:166-200 builds the same rolling window)."""
        eos = self._tokenizer.eos_token or "\n"
        turns = [t for _, t in history[-self.max_history_turns:]]
        return eos.join(turns + [text]) + eos

    def __call__(self, text: str, history: list[tuple[str, str]]) -> str:
        import torch

        self._load()
        t0 = time.time()
        prompt = self._format(text, history)
        enc = self._tokenizer(prompt, return_tensors="pt", truncation=True,
                              max_length=512)
        if self.seed is not None:
            torch.manual_seed(self.seed + self.total_generations)
        with torch.no_grad():
            out = self._model.generate(
                **enc, max_new_tokens=self.max_new_tokens,
                do_sample=not self.greedy,
                temperature=self.temperature if not self.greedy else None,
                top_p=self.top_p if not self.greedy else None,
                pad_token_id=self._tokenizer.pad_token_id)
        reply = self._tokenizer.decode(out[0, enc["input_ids"].shape[1]:],
                                       skip_special_tokens=True).strip()
        self.total_generations += 1
        self.total_processing_time_ms += (time.time() - t0) * 1000.0
        return reply

    def stats(self) -> dict:
        return {"backend": "hf-causal-lm", "model_dir": self.model_dir,
                "total_generations": self.total_generations,
                "total_processing_time_ms": self.total_processing_time_ms}


class OpenAICompatResponder:
    """OpenAI-compatible /chat/completions over stdlib HTTP (reference
    OpenAILLM, conversation_llm.py:270-434)."""

    def __init__(self, base_url: str, model: str = "gpt-3.5-turbo",
                 api_key: Optional[str] = None, timeout_s: float = 30.0,
                 max_tokens: int = 150, temperature: float = 0.7,
                 system_prompt: str = DEFAULT_SYSTEM_PROMPT,
                 max_history_turns: int = 10):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout_s = timeout_s
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.system_prompt = system_prompt
        self.max_history_turns = max_history_turns
        self.total_generations = 0
        self.total_tokens_used = 0

    def _messages(self, text: str, history: list[tuple[str, str]]) -> list:
        msgs = [{"role": "system", "content": self.system_prompt}]
        for role, turn in history[-self.max_history_turns:]:
            msgs.append({"role": "assistant" if role == "assistant" else "user",
                         "content": turn})
        msgs.append({"role": "user", "content": text})
        return msgs

    def __call__(self, text: str, history: list[tuple[str, str]]) -> str:
        payload = json.dumps({
            "model": self.model,
            "messages": self._messages(text, history),
            "max_tokens": self.max_tokens,
            "temperature": self.temperature,
        }).encode()
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(self.base_url + "/chat/completions",
                                     data=payload, headers=headers,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            body = json.loads(r.read())
        reply = body["choices"][0]["message"]["content"].strip()
        self.total_generations += 1
        usage = body.get("usage") or {}
        self.total_tokens_used += int(usage.get("total_tokens", 0))
        return reply

    def stats(self) -> dict:
        return {"backend": "openai-compat", "base_url": self.base_url,
                "model": self.model,
                "total_generations": self.total_generations,
                "total_tokens_used": self.total_tokens_used}


def build_responder_chain(primary: str = "rule_based",
                          hf_model_dir: Optional[str] = None,
                          openai_base_url: Optional[str] = None,
                          openai_model: str = "gpt-3.5-turbo",
                          openai_api_key: Optional[str] = None,
                          ) -> ResponderChain:
    """Assemble the reference's primary->fallback chain
    (conversation_llm.py:563-579: configured primary first, then the rest,
    rule-based always last)."""
    backends: dict[str, Responder] = {}
    if hf_model_dir:
        backends["local"] = HFCausalLMResponder(hf_model_dir)
    if openai_base_url:
        backends["openai"] = OpenAICompatResponder(
            openai_base_url, model=openai_model, api_key=openai_api_key)
    order = [primary] + [k for k in ("local", "openai") if k != primary]
    chain = [backends[k] for k in order if k in backends]
    chain.append(RuleBasedResponder())
    return ResponderChain(chain)
