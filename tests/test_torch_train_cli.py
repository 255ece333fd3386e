"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: what the reference's tests pin of training
(``tests/test_substrate.py``' loss and resume tests,
``tests/test_fault_tolerance.py``' checkpoint payload, stream guard and
kill-and-resume tests), run through the port with ``--device cpu``.

The kill-and-resume test SIGKILLs a ``--compress-grads`` run after its
first checkpoint, resumes it, and requires the loss log (float.hex a step)
to equal an uninterrupted run's bit for bit: the parameters, the int8
error-feedback residuals, the optimizer state, the watchdog baseline and
the data cursor all survive the kill.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_dev_mesh

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = ["--device", "cpu"]


def test_train_loop_loss_decreases(tmp_path):
    losses = train_mod.main(CPU + [
        "--arch", "qwen3-1.7b", "--smoke", "--steps", "40",
        "--batch", "8", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "20"])
    assert len(losses) == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_train_resume_continues(tmp_path):
    flags = CPU + ["--arch", "fourierpim-lm", "--smoke", "--batch", "4",
                   "--seq", "32", "--ckpt-dir", str(tmp_path)]
    train_mod.main(flags + ["--steps", "20", "--ckpt-every", "10"])
    losses2 = train_mod.main(flags + ["--steps", "30"])
    # the resumed run covers steps 20..30 only
    assert len(losses2) == 10
    assert ckpt_lib.latest_step(str(tmp_path)) == 30


TRAIN_FLAGS = CPU + ["--arch", "qwen3-1.7b", "--smoke", "--batch", "4",
                     "--seq", "16", "--seed", "3", "--mesh", "1x1x1",
                     "--compress-grads"]


def test_train_checkpoint_carries_grad_err_and_extra(tmp_path):
    """The saved tree holds the fp32 parameters, the optimizer state and
    the error-feedback residual with its leading pod axis; the manifest's
    ``extra`` carries the watchdog state and the data cursor."""
    ck = str(tmp_path / "ck")
    train_mod.main(TRAIN_FLAGS + ["--steps", "2", "--ckpt-dir", ck,
                                  "--ckpt-every", "2"])
    step = ckpt_lib.latest_step(ck)
    assert step == 2
    man = ckpt_lib.read_manifest(ck, step)
    by_key = {e["key"]: e for e in man["arrays"]}
    err = {k.split("/", 1)[1]: e for k, e in by_key.items()
           if k.startswith("grad_err/")}
    params = {k.split("/", 1)[1]: e for k, e in by_key.items()
              if k.startswith("params/")}
    assert err and set(err) == set(params)   # one residual a leaf
    for name, e in err.items():
        assert e["shape"] == [1] + params[name]["shape"], name
        assert params[name]["dtype"] == "float32"
    assert by_key["opt/step"]["dtype"] == "int32"
    assert {k.split("/")[1] for k in by_key if k.startswith("opt/")} \
        == {"m", "v", "step"}
    extra = man["extra"]
    assert extra["compress_grads"] is True
    assert extra["data"] == {"next_step": 2, "seed": 3,
                             "global_batch": 4, "seq": 16}
    wd = extra["watchdog"]
    assert wd["seen"] == 2 and wd["ewma"] is not None


def test_train_resume_refuses_stream_mismatch(tmp_path):
    """Resuming with a different --seed would replay a different stream
    while pretending to continue: the cursor guard refuses."""
    ck = str(tmp_path / "ck")
    train_mod.main(TRAIN_FLAGS + ["--steps", "2", "--ckpt-dir", ck,
                                  "--ckpt-every", "2"])
    bad = [v if v != "3" else "4" for v in TRAIN_FLAGS]
    with pytest.raises(RuntimeError, match="DIFFERENT stream"):
        train_mod.main(bad + ["--steps", "4", "--ckpt-dir", ck])


def test_train_refuses_a_model_axis_and_bad_meshes():
    """``--mesh 2x2`` trains the LM split over a model axis of 2: its
    losses within rtol 1e-5 of the unsharded run's (the model shards' fp32
    partial sums in another order). Bad meshes are refused, and so is a
    model axis with ``--compress-grads`` (the reference's CLI refuses
    ``--mesh 2x2 --compress-grads`` too)."""
    base = CPU + ["--arch", "qwen3-1.7b", "--smoke", "--steps", "3",
                  "--batch", "4", "--seq", "16"]
    np.testing.assert_allclose(train_mod.main(base + ["--mesh", "2x2"]),
                               train_mod.main(base), rtol=1e-5)
    for bad in (["--mesh", "2"], ["--mesh", "3x1"], ["--compress-grads"],
                ["--mesh", "2x1", "--compress-grads"],
                ["--mesh", "1x1x2", "--compress-grads"]):
        with pytest.raises(SystemExit):
            train_mod.main(base + bad)


@pytest.mark.parametrize("n_pods,axes", [
    (None, {"data": 2, "model": 1}),
    (3, {"pod": 3, "data": 2, "model": 1})])
def test_make_dev_mesh_names_its_axes(n_pods, axes):
    """``--mesh DxM`` and ``--mesh PxDxM`` both come from
    ``make_dev_mesh``: its axes in the reference's order."""
    mesh = make_dev_mesh(2, 1, n_pods=n_pods, device="cpu")
    assert dict(mesh.shape) == axes
    assert list(mesh.shape) == list(axes)


def test_train_data_mesh_runs_the_same_step(capsys):
    """``--mesh 2x1``: a mesh context of the one process, the same step:
    the losses equal the unsharded run's."""
    base = CPU + ["--arch", "fourierpim-lm", "--smoke", "--steps", "3",
                  "--batch", "4", "--seq", "16"]
    assert train_mod.main(base + ["--mesh", "2x1"]) == train_mod.main(base)
    assert "[train] mesh={'data': 2, 'model': 1} per-device batch=2" in \
        capsys.readouterr().out


def test_train_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


KILL_FLAGS = CPU + ["--arch", "qwen3-1.7b", "--smoke", "--batch", "4",
                    "--seq", "16", "--seed", "3", "--mesh", "2x1x1",
                    "--compress-grads", "--steps", "12"]


def _spawn_train(extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + KILL_FLAGS
        + extra, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _parse_loss_log(path):
    """step -> hex loss; a step run again after the resume must agree bit
    for bit."""
    out = {}
    with open(path) as f:
        for line in f:
            step, hexval = line.split()
            if step in out:
                assert out[step] == hexval, \
                    f"step {step} diverged after resume: " \
                    f"{out[step]} vs {hexval}"
            out[step] = hexval
    return out


def test_kill_and_resume_bitwise_identical(tmp_path):
    log_ref = str(tmp_path / "ref.log")
    proc = _spawn_train(["--loss-log", log_ref])
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out

    ck = str(tmp_path / "ck")
    log_kill = str(tmp_path / "kill.log")
    victim = _spawn_train(["--loss-log", log_kill, "--ckpt-dir", ck,
                           "--ckpt-every", "3"])
    try:
        deadline = time.time() + 120
        while ckpt_lib.latest_step(ck) is None:
            assert victim.poll() is None, \
                f"train exited before a checkpoint: " \
                f"{victim.communicate()[0]}"
            assert time.time() < deadline, "no checkpoint within 120 s"
            time.sleep(0.02)
        victim.send_signal(signal.SIGKILL)
        victim.communicate(timeout=60)
    finally:
        victim.kill()
    assert victim.returncode == -signal.SIGKILL
    killed_at = ckpt_lib.latest_step(ck)
    assert killed_at is not None and killed_at < 12, \
        f"kill landed too late (ckpt step {killed_at}): nothing to resume"

    resume = _spawn_train(["--loss-log", log_kill, "--ckpt-dir", ck,
                           "--ckpt-every", "3"])
    out, _ = resume.communicate(timeout=300)
    assert resume.returncode == 0, out
    assert f"resumed from step {killed_at}" in out \
        and "(grad_err restored)" in out, out

    ref = _parse_loss_log(log_ref)
    got = _parse_loss_log(log_kill)   # re-run steps agree bit for bit
    assert set(ref) == {str(s) for s in range(12)}
    assert got == ref, "resumed trajectory diverged from uninterrupted run"
