"""Training supervisor: restart-on-stall wrapper around the port's train
CLI; counterpart of ``meanflow_audio_codec_tpu/tools/supervise.py``.

A training process can hang without exiting: a device that stops
answering, a collective whose peer died, a stuck host read. The process
then burns its reservation until someone notices.

This wrapper runs ``python -m meanflow_audio_codec_torch.train <args>`` as a
child process, treats its stdout as a heartbeat, and on ``--stall-timeout``
seconds of silence kills the child and relaunches it with ``--resume``
appended, up to ``--max-restarts`` times. Stdout passes through unchanged, so logs and
whatever reads the output see the same stream they would from a bare run.

Two rules keep the restart budget meaningful across a 14-hour run:

* **Outage gating.** A device outage longer than the stall timeout would
  otherwise burn one restart per ``stall_timeout`` (each relaunch sits
  silent at device init and is killed again). After a stall kill the
  supervisor first probes device liveness with a short, separate process
  (:data:`DEFAULT_PROBE`: a card is present, one small computation on it,
  a synchronisation and a host read) and, while the probe fails, waits
  with doubling backoff — without consuming restarts — up to
  ``--max-outage-wait`` seconds per continuous outage.
* **Progress credit.** A child that heartbeat for longer than
  ``--healthy-seconds`` before stalling resets the restart counter:
  spaced-out stalls over a long run each cost one restart, not a slice of
  a shared budget.

    python -m meanflow_audio_codec_torch.tools.supervise \
        --stall-timeout 600 --max-restarts 5 -- \
        --config outputs/run/config.json --workdir outputs/run

A sharded run is supervised by passing the launcher as ``--command``
(``--command "torchrun --nproc-per-node 4 -m
meanflow_audio_codec_torch.train"``): every rank's output reaches the
supervisor through the launcher, and a stall kill ends them all.

Exit code: the child's final exit code (0 on success), or 75 (EX_TEMPFAIL)
when the restart budget — or the outage wait budget — is exhausted while
still stalled.
"""

from __future__ import annotations

import argparse
import os
import selectors
import shlex
import subprocess
import sys
import time

EXIT_EXHAUSTED = 75  # EX_TEMPFAIL: gave up restarting a stalled child


def _terminate(proc: subprocess.Popen, grace: float = 10.0) -> None:
    """SIGTERM, then SIGKILL after a grace period. Never raises."""
    if proc.poll() is not None:
        return
    try:
        proc.terminate()
        try:
            proc.wait(timeout=grace)
            return
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=grace)
    except OSError:
        pass


#: Probe that exercises the actual failure surface: the card is present,
#: one tiny computation runs on it, the device synchronises and the result
#: is read on the host (exit 1 without a card).
DEFAULT_PROBE = [
    "-c",
    "import torch; import sys; "
    "torch.cuda.is_available() or sys.exit(1); "
    "x = torch.ones(8, device='cuda').sum(); torch.cuda.synchronize(); "
    "print(float(x.cpu()))",
]


def _device_alive(probe_command: list[str], probe_timeout: float) -> bool:
    """Run the liveness probe; alive iff it exits 0 within the timeout."""
    try:
        rc = subprocess.run(probe_command, timeout=probe_timeout,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL).returncode
    except subprocess.TimeoutExpired:
        return False
    except OSError:
        return False
    return rc == 0


def _wait_out_outage(probe_command: list[str], probe_timeout: float,
                     outage_backoff: float, max_outage_wait: float) -> bool:
    """Block until the device probe passes; False if the wait budget ran
    out first. Called after a stall kill, before spending a restart."""
    waited = 0.0
    backoff = outage_backoff
    while not _device_alive(probe_command, probe_timeout):
        if waited >= max_outage_wait:
            print(f"[supervise] device still unreachable after "
                  f"{waited:.0f}s — giving up", flush=True)
            return False
        pause = min(backoff, max_outage_wait - waited)
        print(f"[supervise] device probe failed — waiting {pause:.0f}s "
              f"(outage {waited:.0f}s/{max_outage_wait:.0f}s)", flush=True)
        time.sleep(pause)
        waited += pause
        backoff = min(backoff * 2, 600.0)
    return True


def run_supervised(train_args: list[str], stall_timeout: float,
                   max_restarts: int, python: str | None = None,
                   command: list[str] | None = None,
                   heartbeat_poll: float = 1.0,
                   probe_command: list[str] | None = None,
                   probe_timeout: float = 120.0,
                   outage_backoff: float = 60.0,
                   max_outage_wait: float = 7200.0,
                   healthy_seconds: float = 3600.0) -> int:
    """Supervise one training run; returns the exit code to propagate.

    ``command`` overrides the child argv before ``train_args`` (tests, or a
    launcher such as ``torchrun``); by default the child is
    ``[sys.executable, -u, -m, meanflow_audio_codec_torch.train,
    *train_args]``.
    ``probe_command`` enables outage gating (None disables it — the CLI
    passes :data:`DEFAULT_PROBE`); a child that heartbeat for longer than
    ``healthy_seconds`` before stalling resets the restart counter.
    """
    if command is None:
        command = [python or sys.executable, "-u", "-m",
                   "meanflow_audio_codec_torch.train"]
    restarts = 0
    args = list(train_args)
    while True:
        argv = command + args
        print(f"[supervise] launch (attempt {restarts + 1}/"
              f"{max_restarts + 1}): {' '.join(argv)}", flush=True)
        # Binary, unbuffered pipe + non-blocking raw os.read: a buffered
        # TextIOWrapper.readline() would pull burst output into a userspace
        # buffer invisible to select (delaying passthrough, dropping it on a
        # stall kill) and block forever on a child hung mid-line. Any bytes
        # count as a heartbeat; an incremental decoder keeps multi-byte
        # characters split across chunks intact.
        import codecs

        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, bufsize=0)
        fd = proc.stdout.fileno()
        os.set_blocking(fd, False)
        decoder = codecs.getincrementaldecoder("utf-8")("replace")

        def pump() -> bool:
            """Drain currently-available bytes; True if any arrived."""
            got = False
            while True:
                try:
                    data = os.read(fd, 65536)
                except BlockingIOError:
                    break
                except OSError:
                    data = b""
                if not data:
                    break
                got = True
                sys.stdout.write(decoder.decode(data))
            if got:
                sys.stdout.flush()
            return got

        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        launch_time = time.monotonic()
        last_beat = launch_time
        stalled = False
        try:
            while proc.poll() is None:
                if sel.select(timeout=heartbeat_poll) and pump():
                    last_beat = time.monotonic()
                if time.monotonic() - last_beat > stall_timeout:
                    stalled = True
                    break
            # drain whatever remains after exit or before the kill
            pump()
            tail = decoder.decode(b"", final=True)
            if tail:
                sys.stdout.write(tail)
                sys.stdout.flush()
        finally:
            sel.close()
        if not stalled:
            rc = proc.wait()
            if rc == 0:
                if restarts:
                    print(f"[supervise] completed after {restarts} "
                          f"restart(s)", flush=True)
                return 0
            print(f"[supervise] child exited rc={rc}", flush=True)
            return rc  # real failures are not retried — surface them
        print(f"[supervise] no output for {stall_timeout:.0f}s — killing "
              f"and resuming", flush=True)
        _terminate(proc)
        if last_beat - launch_time > healthy_seconds and restarts:
            print(f"[supervise] child was healthy for "
                  f"{last_beat - launch_time:.0f}s — resetting restart "
                  f"budget", flush=True)
            restarts = 0
        if probe_command is not None and not _wait_out_outage(
                probe_command, probe_timeout, outage_backoff,
                max_outage_wait):
            return EXIT_EXHAUSTED
        restarts += 1
        if restarts > max_restarts:
            print("[supervise] restart budget exhausted", flush=True)
            return EXIT_EXHAUSTED
        if "--resume" not in args:
            args = args + ["--resume"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        usage="python -m meanflow_audio_codec_torch.tools.supervise "
              "[options] -- <train args>")
    parser.add_argument("--stall-timeout", type=float, default=600.0,
                        help="seconds of child silence before a restart "
                             "(default 600; trainer prints every 50 steps)")
    parser.add_argument("--max-restarts", type=int, default=5)
    parser.add_argument("--probe-timeout", type=float, default=120.0,
                        help="seconds the device-liveness probe may take")
    parser.add_argument("--max-outage-wait", type=float, default=7200.0,
                        help="max seconds to wait out one continuous "
                             "device outage (restarts are not consumed "
                             "while the probe fails)")
    parser.add_argument("--healthy-seconds", type=float, default=3600.0,
                        help="a child that heartbeat this long before "
                             "stalling resets the restart counter")
    parser.add_argument("--no-probe", action="store_true",
                        help="disable outage gating (restart immediately "
                             "after every stall kill)")
    parser.add_argument("--command", type=shlex.split, default=None,
                        help="the child's command line before the train "
                             "arguments, one quoted string (default: this "
                             "Python, -u -m meanflow_audio_codec_torch.train)")
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="arguments after -- go to the train CLI "
                             "verbatim")
    args = parser.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args:
        parser.error("no train arguments given (use -- <args>)")
    probe = None if args.no_probe else [sys.executable, *DEFAULT_PROBE]
    return run_supervised(train_args, args.stall_timeout, args.max_restarts,
                          command=args.command, probe_command=probe,
                          probe_timeout=args.probe_timeout,
                          max_outage_wait=args.max_outage_wait,
                          healthy_seconds=args.healthy_seconds)


if __name__ == "__main__":
    raise SystemExit(main())
