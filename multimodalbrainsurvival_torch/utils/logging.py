"""Metric logging behind ``--log``: a ``metrics.jsonl`` stream, and
TensorBoard where tensorboardX is installed.

The port's own copy of ``multimodalbrainsurvival_tpu/utils/logging.py``
(stdlib only). The reference logs scalars through tensorboardX behind
``--log`` (``2_HistoPath_train.py:346-364``); this writer keeps that surface
and writes one JSON object per event to ``metrics.jsonl`` whether or not
tensorboardX imports. Nothing is installed or downloaded.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricWriter:
    def __init__(self, log_dir: str | None = None, jsonl_path: str | None = None):
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass
            if jsonl_path is None:
                jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def _write(self, record: dict) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"ts": time.time(), **record}) + "\n")
            self._jsonl.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._write({"tag": tag, "value": float(value), "step": step})

    def text(self, tag: str, value: Any) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, str(value))
        self._write({"tag": tag, "text": str(value)})

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
