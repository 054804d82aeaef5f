"""Running a command the tests start over ``torch.distributed.run``.

``subprocess.run(..., timeout=)`` raises ``TimeoutExpired`` with no
assertion message when the command outlives its limit, and the output of
the ranks is lost with it.  ``run_launcher`` fails the test instead, with
the tail of what the command printed to its stdout and stderr by then."""
from __future__ import annotations

import subprocess

import pytest

TAIL = 3000  # characters of each stream a failure shows


def _text(stream) -> str:
    if stream is None:
        return ""
    return stream.decode(errors="replace") if isinstance(stream, bytes) else stream


def run_launcher(cmd, *, env, timeout: float) -> subprocess.CompletedProcess:
    """``cmd`` run to its end with its output captured as text; cut at
    ``timeout`` seconds, it fails the test with its stdout and stderr."""
    try:
        return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"{' '.join(map(str, cmd))} did not end within {timeout} s\n"
                    f"--- stdout:\n{_text(e.stdout)[-TAIL:]}\n--- stderr:\n{_text(e.stderr)[-TAIL:]}")
