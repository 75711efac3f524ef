"""PyTorch port, the speculative-depth tools on the CPU (tiny config):
``tools/trained_loop.py`` (train -> export -> serve -> measure, a handful
of steps) prints its three phase lines with every measurement, and
``tools/spec_depth_rounds.py --tiny`` its per-batch lines, the Jacobi
frames equal to the sequential loop's.
"""

import json
import os

from fireredtts2_tpu_torch.tools import spec_depth_rounds, trained_loop

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_trained_loop_phase_lines(tmp_path):
    lines = []
    out = str(tmp_path / "work")
    trained_loop.run(steps_lm=3, steps_codec=2, out=out, device="cpu",
                     log=lines.append)
    phases = [json.loads(ln) for ln in lines]
    assert [p["phase"] for p in phases] == ["train_lm", "train_codec",
                                            "summary"]
    s = phases[-1]
    assert s["config"] == "tiny" and 0 <= s["token_acc_trained"] <= 1
    assert [r["label"] for r in s["rounds"]] == [
        "trained prev-frame t1", "trained draft-init t1",
        "trained draft-init t10", "random prev-frame t1"]
    for r in s["rounds"]:
        assert 1 <= r["rounds_mean"] <= r["rounds_max"] <= r["worst_case"] == 3
    for key in ("kernel_overlap_trained", "kernel_overlap_random"):
        assert set(s[key]) == set(trained_loop.PLANS)
        assert all(0 <= v <= 1 for v in s[key].values())
    assert s["qa_total"] == 5 and s["fidelity_ran"] is True
    assert os.path.isdir(os.path.join(out, "serving", "torch"))


def test_spec_depth_rounds_tiny():
    lines = []
    rows = spec_depth_rounds.run(batches=(2,), frames=4, tiny=True,
                                 device="cpu", log=lines.append)
    [r] = rows
    assert r["frames_equal_sequential"] == 4
    assert r["kernel_b_frames_equal_sequential"] == 4
    assert 1 <= r["rounds_mean"] <= r["rounds_max"] <= 3
    row = json.loads(lines[-1])["spec_depth_rounds"]
    assert row["B"] == 2 and row["jacobi_ms_per_frame"] > 0
