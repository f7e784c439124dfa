"""Training observability (port of ``tpugan/utils/logging.py``): the same
scalar set (losses, D(x), D(G(z)), ``images_per_sec``) to stdout and to a
``metrics.jsonl`` file in the JAX package's format.  TensorBoard event files
are not written."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a",
                          buffering=1)

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train") -> None:
        rec = {"step": int(step), "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"[{prefix}] step {step}: {parts}", flush=True)

    def close(self) -> None:
        self.jsonl.close()
