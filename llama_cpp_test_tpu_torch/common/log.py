"""Copy of llama_cpp_test_tpu/common/log.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Leveled asynchronous logger — the common/log.{h,cpp} analogue.

The reference's logger is a dedicated writer thread fed by a message queue
so hot paths never block on stderr (common/log.cpp: log_thread + ring).
Same shape here: log calls enqueue preformatted records; one daemon thread
drains to the sink. Levels, timestamps and colors mirror the reference's
LOG_DBG/INF/WRN/ERR macros; env mirrors:

  LLAMA_LOG_LEVEL    debug|info|warn|error|none   (default info)
  LLAMA_LOG_TIMESTAMPS=1   prefix wall-clock timestamps
  LLAMA_LOG_COLORS=1       ANSI-color the level tag
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Any, TextIO

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "none": 100}
_COLORS = {"debug": "\x1b[90m", "info": "\x1b[32m", "warn": "\x1b[33m",
           "error": "\x1b[31m"}
_RESET = "\x1b[0m"


class Logger:
    def __init__(self, sink: TextIO | None = None):
        self.level = LEVELS.get(
            os.environ.get("LLAMA_LOG_LEVEL", "info").lower(), 20)
        self.timestamps = os.environ.get("LLAMA_LOG_TIMESTAMPS") == "1"
        self.colors = os.environ.get("LLAMA_LOG_COLORS") == "1"
        self._sink = sink or sys.stderr
        self._q: queue.Queue = queue.Queue(maxsize=4096)
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                if self._thread is None or not self._thread.is_alive():
                    self._thread = threading.Thread(
                        target=self._drain, daemon=True)
                    self._thread.start()

    def _drain(self) -> None:
        while True:
            rec = self._q.get()
            try:
                if rec is None:
                    return
                try:
                    self._sink.write(rec)
                    if self._q.empty():
                        self._sink.flush()
                except Exception:
                    pass
            finally:
                # task_done AFTER the write: flush() joins the queue, so the
                # final record is guaranteed on the sink when flush returns
                # (popping before writing left a window where flush() saw an
                # empty queue with the last record still unwritten)
                self._q.task_done()

    def set_level(self, level: str) -> None:
        self.level = LEVELS[level]

    def log(self, level: str, fmt: str, *args: Any) -> None:
        if LEVELS[level] < self.level:
            return
        msg = fmt % args if args else fmt
        tag = level[0].upper()
        if self.colors and level in _COLORS:
            tag = _COLORS[level] + tag + _RESET
        ts = ""
        if self.timestamps:
            t = time.time()
            ts = time.strftime("%H:%M:%S", time.localtime(t)) + \
                f".{int((t % 1) * 1000):03d} "
        rec = f"{ts}{tag} {msg}\n"
        self._ensure_thread()
        try:
            self._q.put_nowait(rec)
        except queue.Full:  # hot path must never block: drop, count nothing
            pass

    def debug(self, fmt: str, *args: Any) -> None:
        self.log("debug", fmt, *args)

    def info(self, fmt: str, *args: Any) -> None:
        self.log("info", fmt, *args)

    def warn(self, fmt: str, *args: Any) -> None:
        self.log("warn", fmt, *args)

    def error(self, fmt: str, *args: Any) -> None:
        self.log("error", fmt, *args)

    def flush(self, timeout: float = 2.0) -> None:
        """Drain pending records (tests / process exit): waits until every
        enqueued record has been WRITTEN (queue.join with a timeout), not
        merely dequeued."""
        if self._thread is not None and self._thread.is_alive():
            done = threading.Event()
            waiter = threading.Thread(
                target=lambda: (self._q.join(), done.set()), daemon=True)
            waiter.start()
            done.wait(timeout)
        try:
            self._sink.flush()
        except Exception:
            pass


_logger = Logger()

debug = _logger.debug
info = _logger.info
warn = _logger.warn
error = _logger.error
flush = _logger.flush
set_level = _logger.set_level
