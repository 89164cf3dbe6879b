"""Cross-process file locking.

A verbatim copy of ``fast_plaid_tpu/utils/locking.py``: importing anything
under ``fast_plaid_tpu`` imports jax, and this package never does.

The reference depends on the third-party ``filelock`` package for its
index-mutation lock (reference: python/fast_plaid/search/fast_plaid.py:20-21,
369-376). We own the primitive: an fcntl/msvcrt advisory lock with timeout,
reentrant within a process (counted), safe to hold across fork-free threads
when combined with the in-process threading.Lock the API layer also holds.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["FileLock", "Timeout"]


class Timeout(TimeoutError):
    """Raised when the lock cannot be acquired within the timeout."""


class FileLock:
    """Advisory inter-process lock on a lock file (POSIX fcntl / Windows msvcrt)."""

    def __init__(self, path: str, timeout: float = -1.0) -> None:
        self.path = path
        self.timeout = timeout
        self._fd: int | None = None
        self._count = 0
        # Guards only the counter/fd (held briefly) — filelock-style shared
        # count, so the lock is reentrant ACROSS threads of one process and
        # a non-blocking acquire from another thread fails fast instead of
        # waiting out a long-running update.
        self._mutex = threading.Lock()
        self._acquiring = False

    def acquire(self, timeout: float | None = None) -> None:
        timeout = self.timeout if timeout is None else timeout
        deadline = None if timeout < 0 else time.monotonic() + timeout
        while True:
            with self._mutex:
                if self._count > 0:
                    self._count += 1
                    return
                if not self._acquiring:
                    self._acquiring = True
                    break
            # Another thread is mid-flock: honor the timeout while waiting.
            if deadline is not None and time.monotonic() >= deadline:
                msg = f"Could not acquire lock on {self.path}"
                raise Timeout(msg)
            time.sleep(0.01)
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            while True:
                try:
                    self._flock(fd)
                    break
                except OSError:
                    if deadline is not None and time.monotonic() >= deadline:
                        os.close(fd)
                        msg = f"Could not acquire lock on {self.path}"
                        raise Timeout(msg) from None
                    time.sleep(0.05)
            with self._mutex:
                self._fd = fd
                self._count = 1
        finally:
            with self._mutex:
                self._acquiring = False

    @staticmethod
    def _flock(fd: int) -> None:
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:  # pragma: no cover - Windows
            import msvcrt

            msvcrt.locking(fd, msvcrt.LK_NBLCK, 1)

    def release(self) -> None:
        with self._mutex:
            if self._count > 1:
                self._count -= 1
                return
            if self._fd is not None:
                try:
                    import fcntl

                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                except ImportError:  # pragma: no cover - Windows
                    import msvcrt

                    msvcrt.locking(self._fd, msvcrt.LK_UNLCK, 1)
                os.close(self._fd)
                self._fd = None
            self._count = 0

    @property
    def is_locked(self) -> bool:
        return self._count > 0

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
