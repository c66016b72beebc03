"""PyTorch port: the supervisor (``tools/supervise.py``), the seven cases of
tests/test_supervise.py against the port's module, its torch probe and its
``--command`` flag.

The stall timeouts are 15 s where the JAX tests take 30 s: the timer starts
at launch, so it must dominate a child's start-up on a loaded host (the
JAX tests saw flakes at 2 s and 10 s); the children here import nothing.
"""

import sys
import textwrap

import torch

from meanflow_audio_codec_torch.tools import supervise
from meanflow_audio_codec_torch.tools.supervise import (
    DEFAULT_PROBE,
    EXIT_EXHAUSTED,
    _device_alive,
    main,
    run_supervised,
)

STALL = 15


def _child(tmp_path, body: str) -> list[str]:
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(body))
    return [sys.executable, "-u", str(script)]


def test_clean_child_passes_through(tmp_path, capfd):
    rc = run_supervised(["--foo"], stall_timeout=STALL, max_restarts=2,
                        command=_child(tmp_path, """
        import sys
        print("step 0: ok")
        sys.exit(0)
    """))
    assert rc == 0
    assert "step 0: ok" in capfd.readouterr().out


def test_real_failure_not_retried(tmp_path, capfd):
    marker = tmp_path / "launches"
    rc = run_supervised([], stall_timeout=STALL, max_restarts=5,
                        command=_child(tmp_path, f"""
        from pathlib import Path
        m = Path({str(marker)!r})
        m.write_text(m.read_text() + "x" if m.exists() else "x")
        raise SystemExit(3)
    """))
    assert rc == 3
    assert marker.read_text() == "x"  # launched exactly once


def test_stalled_child_restarted_with_resume(tmp_path, capfd):
    """First launch hangs silently; the relaunch (--resume appended)
    completes. The supervisor must kill the hung child and return 0."""
    marker = tmp_path / "launches"
    rc = run_supervised(["--workdir", "w"], stall_timeout=STALL, max_restarts=2,
                        command=_child(tmp_path, f"""
        import sys, time
        from pathlib import Path
        m = Path({str(marker)!r})
        n = len(m.read_text()) if m.exists() else 0
        m.write_text("x" * (n + 1))
        if n == 0:
            print("step 0: before hang")
            time.sleep(120)  # simulated dead-tunnel hang (killed by parent)
        else:
            assert "--resume" in sys.argv, sys.argv
            print("resumed fine")
    """), heartbeat_poll=0.2)
    assert rc == 0
    assert marker.read_text() == "xx"  # exactly one restart
    out = capfd.readouterr().out
    assert "before hang" in out and "resumed fine" in out
    assert "killing" in out


def test_restart_budget_exhausted(tmp_path):
    rc = run_supervised([], stall_timeout=1, max_restarts=1,
                        command=_child(tmp_path, """
        import time
        time.sleep(60)
    """), heartbeat_poll=0.2)
    assert rc == EXIT_EXHAUSTED


def _probe(tmp_path, body: str) -> list[str]:
    script = tmp_path / "probe.py"
    script.write_text(textwrap.dedent(body))
    return [sys.executable, str(script)]


def test_outage_gating_does_not_consume_restarts(tmp_path, capfd):
    """Stall + dead device: the probe fails twice before the tunnel
    'recovers'; those waits must not burn restarts (max_restarts=1 still
    suffices for the single real relaunch)."""
    launches = tmp_path / "launches"
    probes = tmp_path / "probes"
    rc = run_supervised([], stall_timeout=STALL, max_restarts=1,
                        command=_child(tmp_path, f"""
        import sys, time
        from pathlib import Path
        m = Path({str(launches)!r})
        n = len(m.read_text()) if m.exists() else 0
        m.write_text("x" * (n + 1))
        if n == 0:
            time.sleep(120)  # dead-tunnel hang
        else:
            assert "--resume" in sys.argv, sys.argv
            print("resumed fine")
    """), heartbeat_poll=0.2,
                        probe_command=_probe(tmp_path, f"""
        from pathlib import Path
        p = Path({str(probes)!r})
        n = len(p.read_text()) if p.exists() else 0
        p.write_text("x" * (n + 1))
        raise SystemExit(0 if n >= 2 else 1)  # outage for two probes
    """), probe_timeout=30, outage_backoff=0.1, max_outage_wait=60)
    assert rc == 0
    assert launches.read_text() == "xx"  # exactly one relaunch
    assert len(probes.read_text()) == 3  # fail, fail, pass
    out = capfd.readouterr().out
    assert out.count("device probe failed") == 2
    assert "resumed fine" in out


def test_outage_wait_budget_exhausted(tmp_path, capfd):
    """Probe never passes: exit EX_TEMPFAIL without relaunching."""
    launches = tmp_path / "launches"
    rc = run_supervised([], stall_timeout=STALL, max_restarts=5,
                        command=_child(tmp_path, f"""
        import time
        from pathlib import Path
        m = Path({str(launches)!r})
        m.write_text(m.read_text() + "x" if m.exists() else "x")
        time.sleep(120)
    """), heartbeat_poll=0.2,
                        probe_command=[sys.executable, "-c",
                                       "raise SystemExit(1)"],
                        probe_timeout=30, outage_backoff=0.1,
                        max_outage_wait=0.3)
    assert rc == EXIT_EXHAUSTED
    assert launches.read_text() == "x"  # never relaunched into the outage
    assert "giving up" in capfd.readouterr().out


def test_healthy_child_resets_restart_budget(tmp_path, capfd):
    """Two spaced-out stalls, each after a healthy heartbeat stretch,
    with max_restarts=1: progress credit must reset the counter so the
    third launch still happens and completes."""
    launches = tmp_path / "launches"
    rc = run_supervised([], stall_timeout=STALL, max_restarts=1,
                        command=_child(tmp_path, f"""
        import time
        from pathlib import Path
        m = Path({str(launches)!r})
        n = len(m.read_text()) if m.exists() else 0
        m.write_text("x" * (n + 1))
        if n < 2:
            for i in range(15):  # healthy heartbeats for ~3 s
                print(f"step {{i}}")
                time.sleep(0.2)
            time.sleep(120)  # then stall
        else:
            print("done")
    """), heartbeat_poll=0.2, healthy_seconds=2.0)
    assert rc == 0
    assert launches.read_text() == "xxx"
    assert "resetting restart budget" in capfd.readouterr().out


def test_default_probe_is_a_torch_probe_of_the_card():
    """The probe imports torch (never JAX), computes on the card and reads
    the result on the host: it passes exactly when a card is present."""
    code = DEFAULT_PROBE[-1]
    assert "import torch" in code and "jax" not in code
    assert "torch.cuda.synchronize()" in code and "float(" in code
    assert _device_alive([sys.executable, *DEFAULT_PROBE], 120) == (
        torch.cuda.is_available())


def test_cli_runs_the_given_command_and_the_train_module(tmp_path, capfd):
    """``--command`` replaces the default child (the port's train module),
    the train arguments follow it, and the CLI returns the child's code."""
    script = tmp_path / "child.py"
    script.write_text("import sys\nprint('args', sys.argv[1:])\n")
    rc = main(["--no-probe", "--stall-timeout", str(STALL), "--command",
               f"{sys.executable} -u {script}", "--", "--workdir", "w"])
    assert rc == 0
    assert "args ['--workdir', 'w']" in capfd.readouterr().out
    # the default child: the given interpreter runs the port's train module
    fake = tmp_path / "python"
    fake.write_text('#!/bin/sh\necho child "$@"\n')
    fake.chmod(0o755)
    rc = run_supervised(["--x"], stall_timeout=STALL, max_restarts=0,
                        python=str(fake))
    assert rc == 0
    assert ("child -u -m meanflow_audio_codec_torch.train --x"
            in capfd.readouterr().out)
