"""Verbosity-stream logging and de-duplicated user-facing diagnostics.

Copy of ``ompi_tpu/base/output.py`` (the analog of ``opal/util/output.h``
and ``opal_show_help``): per-framework verbosity streams with MCA-var
controlled levels, and templated help messages printed once, repeats
counted.
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

_lock = threading.Lock()
_streams: dict[int, "_Stream"] = {}
_by_name: dict[str, int] = {}
_next_id = 1

#: otpu-lint lock-discipline contract: stream tables and the show_help
#: dedup counts mutate only under the module lock (any thread may log)
_GUARDED_BY = {"_streams": "_lock", "_by_name": "_lock",
               "_next_id": "_lock", "_help_seen": "_lock"}


@dataclass
class _Stream:
    name: str
    verbosity: int = 0
    prefix: str = ""


def open_stream(name: str, verbosity: int = 0, prefix: Optional[str] = None) -> int:
    """Open (or return) a named output stream; returns the stream id."""
    global _next_id
    with _lock:
        if name in _by_name:
            return _by_name[name]
        sid = _next_id
        _next_id += 1
        _streams[sid] = _Stream(name=name, verbosity=verbosity,
                                prefix=prefix if prefix is not None else f"[{name}] ")
        _by_name[name] = sid
        return sid


def set_verbosity(stream: int | str, level: int) -> None:
    with _lock:
        sid = _by_name.get(stream, stream) if isinstance(stream, str) else stream
        if sid in _streams:
            _streams[sid].verbosity = level


def get_verbosity(stream: int | str) -> int:
    with _lock:
        sid = _by_name.get(stream, stream) if isinstance(stream, str) else stream
        return _streams[sid].verbosity if sid in _streams else 0


def output(stream: int | str, level: int, msg: str, *args) -> None:
    """Emit ``msg`` if the stream's verbosity is >= ``level``.

    Level 0 messages are unconditional (reference ``opal_output(0, ...)``).
    """
    with _lock:
        sid = _by_name.get(stream, stream) if isinstance(stream, str) else stream
        st = _streams.get(sid)
    if st is None:
        if level == 0:
            print(msg % args if args else msg, file=sys.stderr)
        return
    if level == 0 or st.verbosity >= level:
        text = msg % args if args else msg
        print(f"{st.prefix}{text}", file=sys.stderr, flush=True)


_help_topics: dict[tuple[str, str], str] = {}
_help_seen: dict[tuple[str, str], int] = {}
_help_window_s = 5.0
_help_last_flush = 0.0


def register_help(topic: str, key: str, template: str) -> None:
    _help_topics[(topic, key)] = template


def show_help(topic: str, key: str, **kwargs) -> str:
    """Render and emit a help message once; repeated emissions are counted.

    Returns the rendered text (also when suppressed) so callers can attach it
    to exceptions.
    """
    global _help_last_flush
    template = _help_topics.get(
        (topic, key), f"[{topic}:{key}] " + " ".join(f"{k}={v}" for k, v in kwargs.items())
    )
    try:
        text = template.format(**kwargs)
    except (KeyError, IndexError):
        text = template
    with _lock:
        n = _help_seen.get((topic, key), 0)
        _help_seen[(topic, key)] = n + 1
    if n == 0:
        banner = "-" * 76
        print(f"{banner}\n{text}\n{banner}", file=sys.stderr, flush=True)
    else:
        now = time.monotonic()
        if now - _help_last_flush > _help_window_s:
            _help_last_flush = now
            print(
                f"[ompi_tpu_torch] {n} more instance(s) of help message {topic}:{key} suppressed",
                file=sys.stderr,
                flush=True,
            )
    return text


def help_seen_counts() -> dict[tuple[str, str], int]:
    with _lock:
        return dict(_help_seen)

