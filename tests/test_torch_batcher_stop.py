"""A stopped pool leaves no consumer waiting: requests still queued when
``ContinuousBatcher.stop`` runs end with an error (a consumer blocked in
such a handle would also hold up the interpreter's exit, as a
``ThreadPoolExecutor`` worker of the server), and a submit after the stop
raises."""

import threading

import pytest

from fireredtts2_tpu_torch.config import tiny_engine_config
from fireredtts2_tpu_torch.engine import FireRedTTS2Engine
from fireredtts2_tpu_torch.runtime.batcher import ContinuousBatcher

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_stop_ends_queued_requests():
    b = ContinuousBatcher(FireRedTTS2Engine(tiny_engine_config(), device="cpu"),
                          max_streams=2)
    b.start()
    with b.burst():                  # held: nothing is admitted yet
        hs = [b.submit(f"Queued {i}.", "[S1]", max_audio_length_ms=400)
              for i in range(3)]
        b.stop()
    assert not b._worker.is_alive()
    for h in hs:                     # ended, not left waiting
        assert h.chunks.get(timeout=30) is None
        assert "batcher stopped" in str(h.error)
    with pytest.raises(RuntimeError, match="batcher stopped"):
        b.submit("Late.", "[S1]")
    assert [t for t in threading.enumerate() if t is b._worker] == []
