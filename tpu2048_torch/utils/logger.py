"""The metric logger: stdout and a JSONL file (counterpart of
``tpu2048/utils/logger.py``'s ``MetricLogger``, same line format and file
name, ``<experiment>_<YYYYMMDD>_<nnn>.jsonl``). wandb is not ported. Lines
are written as they are logged, on the caller's thread."""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Any, Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, experiment_name: str = "train"):
        self.log_file: Optional[Path] = None
        self._fh = None
        if log_dir is not None:
            d = Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            stamp = datetime.now().strftime("%Y%m%d")
            n = 1
            while (d / f"{experiment_name}_{stamp}_{n:03d}.jsonl").exists():
                n += 1
            self.log_file = d / f"{experiment_name}_{stamp}_{n:03d}.jsonl"
            self._fh = open(self.log_file, "a")
            print(f"Logging to: {self.log_file}")

    @staticmethod
    def _fmt(value: Any) -> str:
        if isinstance(value, float):
            if value != 0 and (abs(value) < 0.01 or abs(value) >= 10000):
                return f"{value:.2e}"
            return f"{value:.2f}"
        return str(value)

    def log(self, metrics: dict, step: Optional[int] = None,
            header: Optional[str] = None, verbose: bool = True) -> None:
        """Print ``--- Step N ---`` (or ``header``) and one ``  key: value``
        line per metric when ``verbose``; append one JSON line to the file."""
        if verbose:
            if header is not None:
                print(header)
            elif step is not None:
                print(f"--- Step {step} ---")
            for k, v in metrics.items():
                print(f"  {k}: {self._fmt(v)}")
        if self._fh is not None:
            entry = {"step": step, "timestamp": datetime.now().isoformat()}
            entry.update(metrics)
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()

    def print(self, message: str = "") -> None:
        print(message, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
