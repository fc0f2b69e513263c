"""Multi-process training through the port's CLI on the CPU (the counterpart
of tests/test_multihost.py), and the lanes' checkpoint of a data-parallel
run against the JAX package's mesh layout.

* Two localhost processes (``--num-processes 2``, one Gloo rank each) run
  the trainer to its end: both exit 0, only process 0 logs and writes
  checkpoints, and its manifest is at step 1.
* ``--mesh-data 4`` over 2 processes x 2 local ranks.
* A ``--mesh-data 2`` run resumes bit-identically (2 + 2 steps == 4).
* A JAX-written ``sharded_d = 2`` env_carry resumes in the port at D=2, and
  the port's is read by ``tpu2048.train.loop.load_env_carry`` on a
  2-device mesh."""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.parallel import make_mesh as jmake_mesh
from tpu2048.parallel.train_step import init_sharded_env_carry as jinit_carry
from tpu2048.train import loop as JLOOP
from tpu2048_torch.parallel.train_step import launch
from tpu2048_torch.train import cli

REPO = Path(__file__).resolve().parent.parent
TINY = ["--scan-cap", "48", "-H", "16", "--num-layers", "1", "--warmup-steps", "1",
        "--points", "0.1", "--mono", "1.0", "--upsample-ratio", "0.25", "--device", "cpu"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_processes(tmp_path, procs: int, flags: list, timeout: int = 300) -> list:
    common = [sys.executable, "-m", "tpu2048_torch.train.cli", "train",
              "--coordinator-address", f"127.0.0.1:{_free_port()}",
              "--num-processes", str(procs), "--steps", "2", "--print-freq", "1",
              "--checkpoint-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "logs"),
              *TINY, *flags]
    # Each process in a session of its own, so that a timeout kills its
    # spawned ranks too (they hold its output pipe open).
    running = [subprocess.Popen(common + ["--process-id", str(i)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, cwd=str(REPO), env=dict(os.environ),
                                start_new_session=True)
               for i in range(procs)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in running]
    finally:
        for p in running:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for i, p in enumerate(running):
        assert p.returncode == 0, f"process {i} failed:\n{outs[i][-3000:]}"
    return outs


def _check_rank0_only(tmp_path, outs: list) -> None:
    logs = list((tmp_path / "logs").glob("train_mlp_*.jsonl"))
    assert len(logs) == 1, logs
    rows = [json.loads(line) for line in logs[0].read_text().splitlines()]
    step_rows = [r for r in rows if "avg_score" in r]
    assert len(step_rows) == 2 and step_rows[0]["samples"] > 0
    assert "Data-parallel ranks" in outs[0] and "--- Step 1 ---" in outs[0]
    for out in outs[1:]:
        assert "Data-parallel ranks" not in out and "--- Step" not in out
    manifest = json.loads((tmp_path / "ck" / "train_state.json").read_text())
    assert manifest["train_step"] == 1


def test_two_process_localhost_training(tmp_path):
    outs = _run_processes(tmp_path, 2, ["--episodes", "4", "--batch-size", "4"])
    _check_rank0_only(tmp_path, outs)
    assert "Data-parallel ranks: 2 (gloo, 2 process(es))" in outs[0]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "train_state.json", "train_state.npz"]


def test_mesh_of_four_over_two_processes(tmp_path):
    """Packed lanes, 2 ranks in each of 2 processes; a run over several
    processes keeps no lanes' checkpoint (fresh boards on resume)."""
    outs = _run_processes(tmp_path, 2, ["--mesh-data", "4", "--packed", "--lanes", "8",
                                        "--horizon", "8", "--batch-size", "16"])
    _check_rank0_only(tmp_path, outs)
    assert "Data-parallel ranks: 4 (gloo, 2 process(es))" in outs[0]
    assert "64 env steps/step" in outs[0]
    assert not (tmp_path / "ck" / "env_carry.npz").exists()


RANKS_TIMEOUT_S = 300
D2 = ["--packed", "--lanes", "8", "--horizon", "8", "--batch-size", "16", "--mesh-data", "2",
      "--eval-freq", "2", "--eval-games", "4", "--adaptive-beta", "--print-freq", "100"]


def _d2_run(ckpt, logs, steps, *extra):
    """``train`` of the CLI's flags, its two local ranks killed if they run
    past RANKS_TIMEOUT_S."""
    launch(cli.train_config([*D2, *TINY, "--steps", str(steps), "--checkpoint-dir", str(ckpt),
                             "--log-dir", str(logs), *extra]), timeout_s=RANKS_TIMEOUT_S)


def _npz(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _log_lines(d) -> dict:
    (f,) = Path(d).glob("*.jsonl")
    out = {}
    for line in f.read_text().splitlines():
        entry = json.loads(line)
        entry.pop("timestamp")
        out.setdefault(entry["step"], []).append(entry)
    return out


@pytest.fixture(scope="module")
def d2_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("d2")
    _d2_run(base / "a", base / "la", 4)
    _d2_run(base / "b", base / "lb1", 2)
    _d2_run(base / "b", base / "lb2", 4, "--resume")
    return base


def test_mesh_data_two_resumes_bit_identically(d2_runs):
    for name in ("train_state", "env_carry", "best_model"):
        a, b = _npz(d2_runs / "a" / f"{name}.npz"), _npz(d2_runs / "b" / f"{name}.npz")
        assert set(a) == set(b), name
        ma, mb = json.loads(str(a.pop("__manifest__"))), json.loads(str(b.pop("__manifest__")))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        for m in (ma, mb):
            for k in ("resume", "log_dir", "checkpoint_dir"):
                m.get("config", {}).pop(k, None)
        assert ma == mb, name
    carry = _npz(d2_runs / "a" / "env_carry.npz")
    assert carry["['env_key_data']"].shape == (2, 2) and carry["['boards']"].shape == (8, 4, 4)
    assert not np.array_equal(*carry["['env_key_data']"])
    la, lb = _log_lines(d2_runs / "la"), _log_lines(d2_runs / "lb2")
    assert sorted(lb) == [2, 3] and la[2] == lb[2] and la[3] == lb[3]
    assert len(la[2]) == 2 and "eval/avg_score" in la[2][1]


def test_port_env_carry_reads_in_jax_on_a_mesh_of_two(d2_runs):
    ck = str(d2_runs / "a")
    written = _npz(d2_runs / "a" / "env_carry.npz")
    carry, best = JLOOP.load_env_carry(ck, 8, 48, mesh=jmake_mesh(2))
    assert best is None
    for field in ("boards", "ep_points", "ep_moves"):
        np.testing.assert_array_equal(np.asarray(getattr(carry, field)),
                                      written[f"['{field}']"])
    np.testing.assert_array_equal(np.asarray(carry.env_key), written["['env_key_data']"])
    assert JLOOP.load_env_carry(ck, 8, 48) == (None, None)  # another mesh layout


def test_jax_sharded_env_carry_resumes_at_d2(d2_runs, tmp_path, capfd):
    """The JAX package's D=2 lanes (ep_moves set to 1000) written over the
    port's, then 1 step: the port plays on from them."""
    for f in (d2_runs / "a").glob("train_state.*"):
        shutil.copy(f, tmp_path)
    jcarry = jinit_carry(jmake_mesh(2), jax.random.key(4), 8)
    jcarry = jcarry._replace(ep_moves=jnp.full((8,), 1000, jnp.int32),
                             ep_points=jnp.full((8,), 12345, jnp.int32))
    JLOOP.save_env_carry(str(tmp_path), jcarry, None, 3, 8, 2)
    before = _npz(tmp_path / "env_carry.npz")
    capfd.readouterr()
    _d2_run(tmp_path, tmp_path / "logs", 5, "--resume")
    out = capfd.readouterr().out
    assert "Resumed from step 4" in out and "Resumed packed env carry" in out
    after = _npz(tmp_path / "env_carry.npz")
    assert json.loads(str(after["__manifest__"]))["sharded_d"] == 2
    np.testing.assert_array_equal(after["['env_key_data']"], before["['env_key_data']"])
    moves = after["['ep_moves']"]
    assert (moves == 1008).mean() > 0.5 and ((moves == 1008) | (moves < 8)).all()
    assert (after["['ep_points']"][moves == 1008] >= 12345).all()
