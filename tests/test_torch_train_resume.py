"""Crash and resume in the port's LM training CLI, and runs that cross
between the packages through a checkpoint.

Reduced qwen2.5-3b (fp32) on the CPU, ``--use-pallas`` (the ``matmul``
kernel's plain version runs here, the JAX package's Pallas kernel in
interpret mode), an epoch-bar schedule of 2-step epochs, so a resumed
run replays sparse and dense steps. A run the port crashes and resumes
equals its uninterrupted run bit for bit; a finished run has nothing to
do; a run the JAX CLI starts and checkpoints at step 4, the port's CLI
finishes, and its losses at steps 4-7 equal the JAX package's
uninterrupted run's within the LM tolerance (relative 1e-4); and the
reverse.
"""
import sys

import numpy as np
import pytest

from repro.launch import train as jtrain
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train as ttrain

LM_TOL = 1e-4  # relative, as the LM path's parity tests
COMMON = ["--arch", "qwen2.5-3b", "--reduced", "--steps-per-epoch", "2", "--global-batch", "2",
          "--seq-len", "16", "--log-every", "1"]


def _port(argv):
    return ttrain.run(ttrain.build_parser().parse_args(["--device", "cpu", "--use-pallas",
                                                         *COMMON, *argv]))


def _jax(argv):
    return jtrain.run(jtrain.build_parser().parse_args([*COMMON, *argv]))


def _last(out) -> dict[int, float]:
    """step -> loss, the last occurrence of a replayed step winning."""
    return dict(zip(out["steps"], out["history"], strict=True))


@pytest.fixture(scope="module")
def port_ref():
    return _port(["--steps", "8"])


@pytest.fixture(scope="module")
def jax_ref():
    return _jax(["--steps", "8"])["history"]


@pytest.mark.parametrize("fail_at,every", [(4, 3), (6, 2), (1, 4)])
def test_crash_resume_equals_uninterrupted(port_ref, fail_at, every, tmp_path, capsys):
    out = _port(["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", str(every),
                 "--fail-at-step", str(fail_at)])
    log = capsys.readouterr().out
    saved = (fail_at // every) * every
    assert "[train] restart 0: injected failure" in log
    if saved:
        assert f"[train] resumed from step {saved}" in log
        assert out["ckpt"]["restores"][0]["step"] == saved
    assert out["steps"] == [*range(fail_at), *range(saved, 8)]
    assert [_last(out)[s] for s in range(8)] == port_ref["history"]  # bit for bit
    assert out["final_loss"] == port_ref["history"][-1]
    assert ckpt.list_steps(str(tmp_path))[-1] == 8 - 8 % every
    assert (tmp_path / "hb" / "rank_00000").exists()


def test_finished_run_has_nothing_to_do(tmp_path, capsys, monkeypatch):
    argv = ["--device", "cpu", *COMMON, "--steps", "4", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    ttrain.main()
    assert "done. final loss" in capsys.readouterr().out
    ttrain.main()
    log = capsys.readouterr().out
    assert "resumed from step 4" in log and "nothing to do: already at the target step" in log


def test_jax_started_run_finishes_in_the_port(jax_ref, tmp_path):
    """The JAX CLI trains steps 0-3 and saves step 4; the port's CLI
    resumes there (Adam's step count 4 included) and trains 4-7."""
    first = _jax(["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    np.testing.assert_allclose(first["history"], jax_ref[:4], rtol=1e-6)
    assert ckpt.latest_step(str(tmp_path)) == 4
    out = _port(["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert out["steps"] == [4, 5, 6, 7] and out["rates"] == [0.0, 0.0, 0.8, 0.8]
    np.testing.assert_allclose(out["history"], jax_ref[4:], rtol=LM_TOL)


def test_port_started_run_finishes_in_jax(port_ref, tmp_path):
    """The reverse: the port saves step 4, the JAX CLI resumes and trains
    4-7 as the port's uninterrupted run does."""
    first = _port(["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert first["history"] == port_ref["history"][:4]
    out = _jax(["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    np.testing.assert_allclose(out["history"], port_ref["history"][4:], rtol=LM_TOL)
    assert ckpt.latest_step(str(tmp_path)) == 8
