"""Fault injection for the port's checkpoint/resume path (the counterparts
of tests/test_fault_tolerance.py), driving
``python -m tpu2048_torch.train.cli train --device cpu``:

  * a save interrupted mid-write leaves the previous train state intact and
    loadable, and the run resumes from it;
  * a truncated or bit-flipped train_state.npz raises
    ``CheckpointCorruptError`` on --resume, never trains from garbage;
  * the manifest embedded in the npz wins over a stale .json mirror;
  * SIGKILL at any instant after the first checkpoint leaves a state from
    which --resume runs to completion;
  * in a ``--mesh-data 2`` run, rank 1 writes no file at all.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tests import torch_ranks
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048_torch.parallel import mesh as TM
from tpu2048_torch.train import checkpoint as CKPT
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop as TLOOP

REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--episodes", "4", "--batch-size", "8", "--scan-cap", "48", "-H", "16",
         "--num-layers", "1", "--warmup-steps", "1", "--points", "0.1", "--mono", "1.0",
         "--upsample-ratio", "0.25", "--print-freq", "1", "--checkpoint-freq", "1",
         "--resume", "--device", "cpu"]


def _train(ck, steps: int) -> None:
    cli.main(["train", *FLAGS, "--steps", str(steps), "--checkpoint-dir", str(ck)])


def _train_cmd(tmp_path, steps: int) -> list:
    return [sys.executable, "-m", "tpu2048_torch.train.cli", "train", *FLAGS,
            "--steps", str(steps), "--checkpoint-dir", str(tmp_path / "ck"),
            "--log-dir", str(tmp_path / "logs")]


def _manifest(ck) -> dict:
    with np.load(Path(ck) / "train_state.npz") as data:
        return json.loads(str(data["__manifest__"]))


def _loads(ck) -> dict:
    """The train state of ``ck`` as the trainer loads it; its manifest."""
    cfg = cli.train_config(FLAGS)
    _, model, _ = TLOOP.build_model(cfg)
    return TLOOP.load_train_state(ck, model, "cpu")[3]


def test_interrupted_save_preserves_previous(tmp_path, monkeypatch, capsys):
    ck = tmp_path / "ck"
    _train(ck, 2)
    assert _manifest(ck)["train_step"] == 1
    real_savez = np.savez_compressed

    def crash_mid_write(path, **arrays):
        # A partial file where the temporary would be, then the writer dies.
        Path(path).write_bytes(b"PK\x03\x04 partial garbage")
        raise RuntimeError("injected writer crash")

    monkeypatch.setattr(CKPT.np, "savez_compressed", crash_mid_write)
    with pytest.raises(RuntimeError, match="injected"):
        _train(ck, 4)
    monkeypatch.setattr(CKPT.np, "savez_compressed", real_savez)
    assert _loads(ck)["train_step"] == 1
    assert not list(ck.glob("*.tmp.*"))
    capsys.readouterr()
    _train(ck, 4)
    assert "Resumed from step 2" in capsys.readouterr().out
    assert _manifest(ck)["train_step"] == 3


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_corrupted_checkpoint_detected(tmp_path, damage):
    ck = tmp_path / "ck"
    _train(ck, 2)
    npz = ck / "train_state.npz"
    raw = bytearray(npz.read_bytes())
    if damage == "truncate":
        raw = raw[: len(raw) // 2]
    else:  # a run of flipped bytes mid-file: the zip's CRC-32 catches it on read
        mid = len(raw) // 2
        for i in range(mid, mid + 8):
            raw[i] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(CKPT.CheckpointCorruptError):
        _train(ck, 4)
    assert npz.read_bytes() == bytes(raw)  # nothing written over it


def test_stale_mirror_loses_to_embedded_manifest(tmp_path, capsys):
    ck = tmp_path / "ck"
    _train(ck, 2)
    (ck / "train_state.json").write_text(json.dumps({"train_step": 999}))
    assert _loads(ck)["train_step"] == 1
    capsys.readouterr()
    _train(ck, 3)
    assert "Resumed from step 2" in capsys.readouterr().out
    assert _manifest(ck)["train_step"] == 2


def test_sigkill_then_resume_completes(tmp_path):
    ck = tmp_path / "ck"
    # Run 1: killed with SIGKILL at an arbitrary instant after the first
    # checkpoint (checkpoint-freq 1), possibly mid-save.
    p = subprocess.Popen(_train_cmd(tmp_path, 50), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, cwd=str(REPO))
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if CKPT.checkpoint_exists(ck, "train_state"):
                break
            if p.poll() is not None:
                out = p.communicate()[0].decode()
                pytest.fail(f"run 1 exited before its first checkpoint:\n{out[-3000:]}")
            time.sleep(0.2)
        else:
            pytest.fail("no checkpoint appeared within 300 s")
    finally:
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
        p.communicate()
    banked = _manifest(ck)["train_step"]
    # Run 2: --resume picks up from the banked step and runs to completion.
    total = banked + 3
    out = subprocess.run(_train_cmd(tmp_path, total), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, cwd=str(REPO), timeout=600)
    text = out.stdout.decode()
    assert out.returncode == 0, text[-3000:]
    assert f"Resumed from step {banked + 1}" in text, text[-3000:]
    assert _manifest(ck)["train_step"] == total - 1


def test_mesh_data_two_rank_one_writes_no_file(tmp_path):
    """Two ranks of --mesh-data 2 runs with checkpoints, eval, the metric log
    and viz, packed lanes (the lanes' checkpoint) and exact episodes (the
    best episode fetched from its rank): rank 0 writes each file, rank 1 not
    one."""
    common = ["--mesh-data", "2", "--steps", "3", "--checkpoint-freq", "1", "--eval-freq",
              "2", "--eval-games", "4", "--scan-cap", "48", "-H", "16", "--num-layers", "1",
              "--print-freq", "1", "--device", "cpu"]
    runs = {"packed": ["--packed", "--lanes", "8", "--horizon", "8", "--batch-size", "16"],
            "exact": ["--episodes", "4", "--batch-size", "16"]}
    jobs = [(name, "train_writes",
             dict(argv=[*flags, *common, "--checkpoint-dir", str(tmp_path / name / "ck"),
                        "--log-dir", str(tmp_path / name / "logs"),
                        "--viz-dir", str(tmp_path / name / "viz")],
                  watch=str(tmp_path / name)))
            for name, flags in runs.items()]
    rank0, rank1 = TM.spawn(torch_ranks.run, 2, (2, f"file://{tmp_path}/rendezvous", jobs),
                            timeout_s=300)
    for name in runs:
        assert rank1[name] == [], name
        written = {str(Path(p).relative_to(tmp_path / name)) for _, p in rank0[name]}
        for ckpt in ("train_state", "best_model") + (("env_carry",) if name == "packed" else ()):
            assert {f"ck/{ckpt}.npz", f"ck/{ckpt}.json"} <= written, (name, ckpt)
        assert any(w.startswith("logs/train_mlp_") for w in written), name
        assert any(w.startswith("viz/step_") for w in written) == (name == "exact")
