"""Conversation session management with JSON persistence.

Capability parity with the reference `conversation_manager.py` (sessions +
turns, per-session JSON files, context-window retrieval, expiry cleanup;
:128-466) and the data models of `data_models.py` (ConversationTurn /
ConversationSession).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field, asdict
from typing import Optional


@dataclass
class ConversationTurn:
    turn_id: str
    role: str                    # "user" | "assistant"
    text: str
    timestamp: float
    audio_duration_s: float = 0.0
    metadata: dict = field(default_factory=dict)


@dataclass
class ConversationSession:
    session_id: str
    created_at: float
    updated_at: float
    turns: list[ConversationTurn] = field(default_factory=list)
    metadata: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "session_id": self.session_id,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "turns": [asdict(t) for t in self.turns],
            "metadata": self.metadata,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ConversationSession":
        return cls(
            session_id=d["session_id"],
            created_at=d["created_at"],
            updated_at=d["updated_at"],
            turns=[ConversationTurn(**t) for t in d.get("turns", [])],
            metadata=d.get("metadata", {}),
        )


class SessionManager:
    """Thread-safe session store; optional directory persistence."""

    def __init__(self, persist_dir: Optional[str] = None,
                 expiry_seconds: float = 3600.0,
                 max_context_turns: int = 10):
        self._sessions: dict[str, ConversationSession] = {}
        self._lock = threading.Lock()
        self.persist_dir = persist_dir
        self.expiry_seconds = expiry_seconds
        self.max_context_turns = max_context_turns
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._load_all()

    # -- lifecycle

    def create_session(self, metadata: Optional[dict] = None) -> ConversationSession:
        now = time.time()
        s = ConversationSession(session_id=uuid.uuid4().hex, created_at=now,
                                updated_at=now, metadata=metadata or {})
        with self._lock:
            self._sessions[s.session_id] = s
        self._save(s)
        return s

    def get(self, session_id: str) -> Optional[ConversationSession]:
        with self._lock:
            return self._sessions.get(session_id)

    def add_turn(self, session_id: str, role: str, text: str,
                 audio_duration_s: float = 0.0,
                 metadata: Optional[dict] = None) -> ConversationTurn:
        with self._lock:
            s = self._sessions[session_id]
            turn = ConversationTurn(turn_id=uuid.uuid4().hex, role=role,
                                    text=text, timestamp=time.time(),
                                    audio_duration_s=audio_duration_s,
                                    metadata=metadata or {})
            s.turns.append(turn)
            s.updated_at = time.time()
        self._save(s)
        return turn

    def context_window(self, session_id: str,
                       max_turns: Optional[int] = None) -> list[ConversationTurn]:
        n = max_turns or self.max_context_turns
        with self._lock:
            s = self._sessions.get(session_id)
            return list(s.turns[-n:]) if s else []

    def end_session(self, session_id: str) -> None:
        with self._lock:
            s = self._sessions.pop(session_id, None)
        if s and self.persist_dir:
            self._save(s)

    def cleanup_expired(self) -> int:
        """Drop sessions idle past expiry (reference cleanup loop)."""
        cutoff = time.time() - self.expiry_seconds
        with self._lock:
            dead = [k for k, s in self._sessions.items() if s.updated_at < cutoff]
            for k in dead:
                del self._sessions[k]
        return len(dead)

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    # -- persistence (one JSON file per session, reference
    #    conversation_manager.py:368-466)

    def _path(self, session_id: str) -> str:
        return os.path.join(self.persist_dir, f"{session_id}.json")

    def _save(self, s: ConversationSession) -> None:
        if not self.persist_dir:
            return
        tmp = self._path(s.session_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(s.to_json(), f)
        os.replace(tmp, self._path(s.session_id))

    def _load_all(self) -> None:
        for name in os.listdir(self.persist_dir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.persist_dir, name)) as f:
                    s = ConversationSession.from_json(json.load(f))
                self._sessions[s.session_id] = s
            except (json.JSONDecodeError, KeyError):
                continue  # corrupt file: skip, don't crash the server
