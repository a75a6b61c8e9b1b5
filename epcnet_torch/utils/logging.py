"""Plain-text logging (the ``log_string`` half of ``epcnet_tpu/utils/logging.py``):
``log_string`` prints a timestamped line and appends it to an open log file."""

from __future__ import annotations

import time


def log_string(msg: str, log_file=None) -> None:
    line = f"[{time.strftime('%H:%M:%S')}] {msg}"
    print(line, flush=True)
    if log_file is not None:
        log_file.write(line + "\n")
        log_file.flush()
