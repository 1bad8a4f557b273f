"""The port's trainer CLI, ``python -m repro_torch.launch.train``, on the CPU
(``--device cpu``) in subprocesses: the fault-tolerance contract of
``tests/test_substrate.py`` (killed at step 12 and resumed from the step-10
checkpoint, the post-resume losses equal the uninterrupted run's within
that test's 1e-5), int8 error-feedback compression trains, a model axis
that does not divide the ranks raises, and the default device is the
card.  ``tests/test_torch_launch_mesh.py`` runs it over several ranks."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

SRC = str(pathlib.Path(__file__).parents[1] / "src")
COMMON = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
          "--steps", "20", "--batch", "2", "--seq", "64", "--ckpt-every",
          "10", "--log-every", "1", "--device", "cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def _start(args):
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def _losses(d):
    lines = (d / "metrics.jsonl").read_text().splitlines()
    return {json.loads(line)["step"]: json.loads(line)["loss"]
            for line in lines}


def test_die_resume_matches_uninterrupted(tmp_path):
    full = _start(COMMON + ["--ckpt-dir", str(tmp_path / "full")])
    die = _start(COMMON + ["--ckpt-dir", str(tmp_path / "fault"),
                           "--die-at-step", "12"])
    rc, out, err = _finish(die)
    assert rc == 42, err[-2000:]          # simulated hard failure
    assert "SIMULATED FAILURE at step 12" in out
    assert sorted(p.name for p in (tmp_path / "fault").glob("step_*")) == \
        ["step_00000010"]
    rc, out, err = _finish(_start(COMMON + ["--ckpt-dir",
                                            str(tmp_path / "fault"),
                                            "--resume"]))
    assert rc == 0, err[-2000:]
    assert "resumed from step 10" in out
    rc, out, err = _finish(full)
    assert rc == 0, err[-2000:]
    assert out.splitlines()[0].startswith("corpus: ")
    assert out.splitlines()[-1].startswith("final loss ")
    a, b = _losses(tmp_path / "full"), _losses(tmp_path / "fault")
    assert sorted(a) == list(range(20)) == sorted(b)
    for s in range(10, 20):               # post-resume steps match
        assert abs(a[s] - b[s]) < 1e-5, (s, a[s], b[s])
    hb = json.loads((tmp_path / "full" / "heartbeat.json").read_text())
    assert hb["step"] == 19
    for d in ("full", "fault"):
        assert sorted(p.name for p in (tmp_path / d).glob("step_*")) == \
            ["step_00000010", "step_00000020"]


def test_train_with_compression_converges(tmp_path):
    rc, _, err = _finish(_start(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "12", "--batch", "2", "--seq", "64", "--compress",
         "--log-every", "1", "--ckpt-dir", str(tmp_path / "c"),
         "--ckpt-every", "6", "--device", "cpu"]))
    assert rc == 0, err[-2000:]
    losses = [json.loads(line)["loss"] for line in
              (tmp_path / "c" / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 12 and losses[-1] < losses[0]


def test_model_parallel_waits_for_the_mesh():
    """The mesh spans every rank: alone, a process is one rank, which a
    model axis of 2 does not divide (and the job it formed is closed)."""
    import torch.distributed as dist
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="model_parallel 2 does not "
                                         "divide the 1 ranks"):
        main(["--smoke", "--model-parallel", "2", "--device", "cpu"])
    assert not dist.is_initialized()


def test_default_device_is_the_card(monkeypatch):
    """Without --device the trainer runs on the CUDA card, and raises
    where there is none; it does not fall back to the CPU."""
    import torch
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--steps", "1"])
