"""The trainers' ``log.txt``: a tee of stdout and stderr to a file.

The port's copy of ``diff_sampler_tpu/utils/common.py::Logger`` (the
reference's ``dnnlib/util.py:55-116``), which the JAX training CLIs open in
their run directory.  The rest of that module stays behind: its
``open_url`` downloads.
"""

from __future__ import annotations

import sys
from typing import Optional

__all__ = ["Logger"]


class Logger:
    """Tee stdout / stderr to a log file; ``close`` (or leaving a ``with``
    block) restores them."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True):
        self.file = open(file_name, file_mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write(self, text):
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self):
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self):
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None
