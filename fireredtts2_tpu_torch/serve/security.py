"""Request security: input validation, rate limiting, token auth.

Capability parity with the reference `security_system.py`: regex
InputValidator for injection patterns (:120-227), sliding-window RateLimiter
(:228-312), token SessionManager (:313-408), AuditLogger (:409-492), and a
facade (:493-686).
"""

from __future__ import annotations

import hmac
import hashlib
import logging
import re
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

logger = logging.getLogger("fireredtts2_tpu_torch.security")


# ---------------------------------------------------------------- validation

_INJECTION_PATTERNS = [
    re.compile(r"(?i)\b(union\s+select|drop\s+table|insert\s+into|delete\s+from)\b"),
    re.compile(r"(?i)<\s*script[^>]*>"),
    re.compile(r"(?i)javascript\s*:"),
    re.compile(r"\.\./|\.\.\\"),
    re.compile(r"[;&|`$]\s*(rm|cat|wget|curl|sh|bash|python)\b"),
]

MAX_TEXT_LEN = 10_000


@dataclass
class ValidationResult:
    ok: bool
    reason: str = ""


def validate_text_input(text: str) -> ValidationResult:
    """Reject hostile/oversized TTS text (reference InputValidator)."""
    if not isinstance(text, str) or not text.strip():
        return ValidationResult(False, "empty text")
    if len(text) > MAX_TEXT_LEN:
        return ValidationResult(False, f"text too long (> {MAX_TEXT_LEN})")
    for pat in _INJECTION_PATTERNS:
        if pat.search(text):
            return ValidationResult(False, "input failed security screening")
    # control characters other than whitespace
    if any(ord(c) < 32 and c not in "\t\n\r" for c in text):
        return ValidationResult(False, "control characters in input")
    return ValidationResult(True)


def validate_audio_upload(data: bytes, max_bytes: int = 50 * 1024 * 1024
                          ) -> ValidationResult:
    """Size + magic-byte sniff for wav/flac uploads (replaces the
    reference's libmagic dependency with direct header checks)."""
    if len(data) > max_bytes:
        return ValidationResult(False, "upload too large")
    if len(data) < 12:
        return ValidationResult(False, "upload too small")
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return ValidationResult(True)
    if data[:4] == b"fLaC":
        return ValidationResult(True)
    return ValidationResult(False, "unsupported audio container")


# ---------------------------------------------------------------- rate limit

class RateLimiter:
    """Sliding-window per-client limiter (reference security_system.py:228)."""

    def __init__(self, max_requests: int = 60, window_seconds: float = 60.0):
        self.max_requests = max_requests
        self.window = window_seconds
        self._hits: dict[str, deque] = {}
        self._lock = threading.Lock()

    def allow(self, client_id: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            q = self._hits.setdefault(client_id, deque())
            while q and q[0] <= now - self.window:
                q.popleft()
            if len(q) >= self.max_requests:
                return False
            q.append(now)
            return True

    def remaining(self, client_id: str) -> int:
        with self._lock:
            q = self._hits.get(client_id, ())
            return max(0, self.max_requests - len(q))


# ---------------------------------------------------------------- tokens

class TokenAuthenticator:
    """HMAC-signed bearer tokens with expiry (reference SessionManager
    :313-408 issues opaque tokens; HMAC keeps this stateless)."""

    def __init__(self, secret: Optional[bytes] = None, ttl_seconds: float = 3600):
        self.secret = secret or secrets.token_bytes(32)
        self.ttl = ttl_seconds

    def issue(self, subject: str, now: Optional[float] = None) -> str:
        now = time.time() if now is None else now
        exp = int(now + self.ttl)
        payload = f"{subject}.{exp}"
        sig = hmac.new(self.secret, payload.encode(), hashlib.sha256).hexdigest()
        return f"{payload}.{sig}"

    def verify(self, token: str, now: Optional[float] = None) -> Optional[str]:
        """Returns the subject if valid and unexpired, else None."""
        now = time.time() if now is None else now
        parts = token.rsplit(".", 2)
        if len(parts) != 3:
            return None
        subject, exp_s, sig = parts
        payload = f"{subject}.{exp_s}"
        want = hmac.new(self.secret, payload.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(sig, want):
            return None
        try:
            if now > int(exp_s):
                return None
        except ValueError:
            return None
        return subject


# ---------------------------------------------------------------- audit

class AuditLogger:
    """In-memory + logging audit trail (reference AuditLogger :409-492)."""

    def __init__(self, window: int = 1000):
        self._events: deque = deque(maxlen=window)
        self._lock = threading.Lock()

    def log(self, kind: str, client: str, detail: str = "") -> None:
        with self._lock:
            self._events.append((time.time(), kind, client, detail[:200]))
        logger.info("audit %s client=%s %s", kind, client, detail[:200])

    def recent(self, n: int = 50) -> list:
        with self._lock:
            return list(self._events)[-n:]


# ---------------------------------------------------------------- facade

@dataclass
class SecuritySystem:
    rate_limiter: RateLimiter = field(default_factory=RateLimiter)
    auth: TokenAuthenticator = field(default_factory=TokenAuthenticator)
    audit: AuditLogger = field(default_factory=AuditLogger)
    require_auth: bool = False

    def check_request(self, client_id: str, text: str,
                      token: Optional[str] = None) -> ValidationResult:
        if self.require_auth:
            if token is None or self.auth.verify(token) is None:
                self.audit.log("auth_reject", client_id)
                return ValidationResult(False, "unauthorized")
        if not self.rate_limiter.allow(client_id):
            self.audit.log("rate_limited", client_id)
            return ValidationResult(False, "rate limit exceeded")
        v = validate_text_input(text)
        if not v.ok:
            self.audit.log("input_reject", client_id, v.reason)
        return v


def create_security_system(**kwargs) -> SecuritySystem:
    """Factory (reference security_system.py:688)."""
    return SecuritySystem(**kwargs)
