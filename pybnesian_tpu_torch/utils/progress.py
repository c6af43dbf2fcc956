"""Verbose progress channel (reference util/progress.hpp:8-186).

The reference wraps the vendored `indicators` spinner/progress bars; here the
same verbosity-gated factory pattern prints lightweight line updates. All
search algorithms accept ``verbose``; 0 keeps everything silent.
"""

from __future__ import annotations

import sys
import time

__all__ = ["progress_bar", "spinner", "BaseProgressBar", "ProgressBar",
           "IndeterminateSpinner", "SilentProgress"]


class BaseProgressBar:
    def set_text(self, text: str) -> None:
        raise NotImplementedError

    def set_max_progress(self, n: int) -> None:
        raise NotImplementedError

    def set_progress(self, n: int) -> None:
        raise NotImplementedError

    def tick(self) -> None:
        raise NotImplementedError

    def mark_as_completed(self, text: str = "") -> None:
        raise NotImplementedError


class SilentProgress(BaseProgressBar):
    def set_text(self, text):
        pass

    def set_max_progress(self, n):
        pass

    def set_progress(self, n):
        pass

    def tick(self):
        pass

    def mark_as_completed(self, text=""):
        pass

    def update_status(self, text):
        pass


class ProgressBar(BaseProgressBar):
    def __init__(self, stream=None, min_interval: float = 0.1):
        self.stream = stream or sys.stderr
        self.text = ""
        self.max_progress = 0
        self.progress = 0
        self._last = 0.0
        self.min_interval = min_interval

    def set_text(self, text):
        self.text = text
        self._render(force=True)

    def set_max_progress(self, n):
        self.max_progress = int(n)

    def set_progress(self, n):
        self.progress = int(n)
        self._render()

    def tick(self):
        self.progress += 1
        self._render()

    def _render(self, force=False):
        now = time.time()
        if not force and now - self._last < self.min_interval:
            return
        self._last = now
        if self.max_progress > 0:
            pct = 100.0 * self.progress / self.max_progress
            self.stream.write(
                f"\r{self.text} [{self.progress}/{self.max_progress}] "
                f"{pct:5.1f}%"
            )
        else:
            self.stream.write(f"\r{self.text}")
        self.stream.flush()

    def mark_as_completed(self, text=""):
        self.stream.write(f"\r{text}\n")
        self.stream.flush()


class IndeterminateSpinner(BaseProgressBar):
    _frames = "|/-\\"

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self._i = 0
        self.text = ""

    def update_status(self, text):
        self._i += 1
        frame = self._frames[self._i % len(self._frames)]
        self.stream.write(f"\r{frame} {text}")
        self.stream.flush()

    def set_text(self, text):
        self.update_status(text)

    def set_max_progress(self, n):
        pass

    def set_progress(self, n):
        pass

    def tick(self):
        self._i += 1

    def mark_as_completed(self, text=""):
        self.stream.write(f"\r{text}\n")
        self.stream.flush()


def progress_bar(verbose: int) -> BaseProgressBar:
    """(reference util/progress.hpp progress_bar factory)."""
    return ProgressBar() if verbose else SilentProgress()


def spinner(verbose: int):
    return IndeterminateSpinner() if verbose else SilentProgress()
