"""Run logging: timestamped text logs + structured JSONL metrics.

Copy of :mod:`diffquantum_tpu.utils.logger` (pure Python, no JAX): text
files under ``<path>/text/{name}_{YYYYmmdd-HHMMSS}.txt`` with an ``_aux``
sibling, append + echo semantics, and a JSONL metrics stream (one dict per
line). The port keeps its own copy so it imports nothing of the JAX
package.
"""
from __future__ import annotations

import json
import os
import time
from datetime import datetime


class Logger:
    """Append-only text + JSONL run logger.

    write_text(txt, silent=False): append to main log, echo to stdout.
    write_text_aux(txt, silent=True): append to aux log (silent by default).
    log_metrics(**kv): one JSON line to the metrics file.
    """

    def __init__(self, name: str | None = None, path: str | None = None,
                 echo: bool = True):
        if path is None:
            path = os.path.join(os.getcwd(), "logs")
        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        name = stamp if name is None else f"{name}_{stamp}"
        self.text_dir = os.path.join(path, "text")
        os.makedirs(self.text_dir, exist_ok=True)
        self.log_file = os.path.join(self.text_dir, f"{name}.txt")
        self.log_file_aux = os.path.join(self.text_dir, f"{name}_aux.txt")
        self.metrics_file = os.path.join(self.text_dir, f"{name}_metrics.jsonl")
        self.echo = echo
        self._t0 = time.time()
        if echo:
            print(f"logs are written to {self.log_file}")

    def write_text(self, txt: str, silent: bool = False) -> None:
        with open(self.log_file, "a") as f:
            f.write(txt + "\n")
        if self.echo and not silent:
            print(txt)

    def write_text_aux(self, txt: str, silent: bool = True) -> None:
        with open(self.log_file_aux, "a") as f:
            f.write(txt + "\n")
        if self.echo and not silent:
            print(txt)

    def log_metrics(self, **kv) -> None:
        kv.setdefault("wall_s", round(time.time() - self._t0, 3))
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(kv, default=float) + "\n")

    def log_config(self, cfg: dict, header: str = "arguments ========") -> None:
        """Record run configuration (mirrors `sim_plain.py:36-41`)."""
        self.write_text(header)
        for k, v in cfg.items():
            self.write_text(f"{k}: {v}")


class NullLogger(Logger):
    """No-op logger (keeps trainer code branch-free)."""

    def __init__(self):  # noqa: D401 — intentionally skip file creation
        self.echo = False
        self._t0 = time.time()

    def write_text(self, txt: str, silent: bool = False) -> None:
        pass

    def write_text_aux(self, txt: str, silent: bool = True) -> None:
        pass

    def log_metrics(self, **kv) -> None:
        pass

    def log_config(self, cfg: dict, header: str = "") -> None:
        pass
