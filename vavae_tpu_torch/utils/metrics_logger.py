"""Training-metrics sink (port of ``vavae_tpu/utils/metrics_logger.py``,
JSONL only): appends one JSON line per ``log_scalars`` call to
``{log_dir}/metrics.jsonl``."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
