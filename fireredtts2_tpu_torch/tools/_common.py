"""Shared parts of the probe tools: a probe's specification, its bytes and
operations, and timing on the card (CUDA only)."""

from __future__ import annotations

import dataclasses
import subprocess
import time

import torch

from fireredtts2_tpu_torch.ops import gemv_probe as gp

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def cuda_device(device: str | torch.device = "cuda") -> torch.device:
    """The CUDA device a probe runs on; raises where there is none."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probe tools time kernels on a CUDA device; "
                           f"{dev} is not one (torch.cuda.is_available() = "
                           f"{torch.cuda.is_available()})")
    return dev


def card_line() -> str:
    """nvidia-smi's name and power limit of the card(s)."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
            else f"nvidia-smi gave nothing (exit {res.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def queued_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """CUDA-event time per call of fn, with the calls queued behind a ~25 ms
    device-side spin so that the card runs them back to back while the
    host keeps ahead: device time without the host's launch gaps."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """CUDA-event time per call of fn, host launch gaps included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Host time per call of fn (perf_counter, no synchronise inside): the
    time the host takes to issue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def cold_ms(fn, reps: int = 5, flush_mb: int = 128) -> float:
    """CUDA-event time of single calls of fn, each after a write of
    `flush_mb` MB that evicts the 50 MB L2; the mean over `reps` calls."""
    buf = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        buf.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def library_call_ms(fn, reps: int = 10):
    """(CUDA-event ms, None) of one PyTorch library call, or (None, the
    exception's text) where this PyTorch or card refuses the call."""
    try:
        fn()
        torch.cuda.synchronize()
    except (AttributeError, TypeError, RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return event_ms(fn, reps), None


def rand_weights(mode: str, O: int, K: int, gen: torch.Generator,
                 group: int = 128) -> gp.Mat:
    """Random output-major weights of a probe matrix (x index 0): bf16
    normal, int8 in [-127, 127], or int4 bytes with fp32 group scales."""
    dev = gen.device
    if mode == "bf16":
        return gp.Mat(torch.randn((O, K), generator=gen, device=dev).to(torch.bfloat16),
                      None, 0)
    if mode == "int4":
        w = torch.randint(-128, 128, (O, K // 2), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((O, K // group), generator=gen, device=dev) * 0.02
        return gp.Mat(w, s, 0)
    return gp.Mat(torch.randint(-127, 128, (O, K), generator=gen, device=dev,
                                dtype=torch.int8), None, 0)


def rand_input(M: int, K: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randn((M, K), generator=gen, device=gen.device).to(torch.bfloat16)


@dataclasses.dataclass
class Spec:
    """One probe: kernel P's arguments and what it moves."""
    name: str
    mode: str
    mats: list
    xs: list
    steps: int
    form: str = "sum"
    qgroup: int = 0

    def call(self, load: str = "direct", sync: str = "none") -> gp.ProbeCall:
        return gp.ProbeCall(self.mats, self.xs, self.mode, self.steps,
                            self.form, sync, load, self.qgroup)

    def plain(self) -> torch.Tensor:
        return gp.gemv_probe_plain(self.mats, self.xs, self.mode, self.steps,
                                   self.form)

    @property
    def weight_bytes(self) -> int:
        return gp.weight_bytes(self.mats)

    def io_bytes(self) -> int:
        """Every input read once and the output written once."""
        M = self.xs[0].shape[0]
        n_out = M * (sum(m.w.shape[0] for m in self.mats) * 2
                     if self.form == "y" else 4)
        return self.weight_bytes + sum(x.numel() * 2 for x in self.xs) + n_out

    def ops(self) -> int:
        M = self.xs[0].shape[0]
        return 2 * M * self.steps * sum(m.w.shape[0] * self.xs[m.x].shape[1]
                                        for m in self.mats)

    def streamed_floor_ms(self) -> float:
        """Every step's weights from device memory: steps x bytes."""
        return self.steps * self.weight_bytes / HBM_BYTES_PER_S * 1e3


def measure(spec: Spec, load: str = "direct", sync: str = "none",
            reps: int = 10, cold: bool = False, extra=None) -> dict:
    """Kernel P's time for one call of `spec` (queued CUDA events, or each
    call after an L2 flush with `cold`), per step, and the weight rate.
    ``extra(spec, load)``, where given, returns more entries for the row
    (chip_smoke.py adds its check against the plain version, the plain
    version's time, the bound and the library calls' time)."""
    call = spec.call(load, sync)
    fn = lambda: call.launch(zero=False)    # noqa: E731
    ms = cold_ms(fn, reps) if cold else queued_ms(fn, reps)
    per_step = ms / max(spec.steps, 1)
    row = dict(name=spec.name, mode=spec.mode, load=load, sync=sync,
               cold=cold, M=spec.xs[0].shape[0] if spec.xs else 0,
               steps=spec.steps, weight_mb=spec.weight_bytes / 2 ** 20,
               x_staged=call.x_staged, grid=call.grid, ms=ms,
               per_step_ms=per_step,
               gb_per_s=spec.weight_bytes / (per_step * 1e-3) / 1e9)
    if extra is not None:
        row.update(extra(spec, load))
    return row
