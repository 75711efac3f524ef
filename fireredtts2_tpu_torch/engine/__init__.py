from fireredtts2_tpu_torch.engine.engine import FireRedTTS2Engine, Segment  # noqa: F401
