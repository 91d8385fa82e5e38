"""Structured per-frame metrics -> JSONL (SURVEY.md §5 observability row).

The reference narrates to stdout (match stats my_utilities.h:116-119, PICP
inliers icp_test.cpp:111, map size icp_test.cpp:135); here the same signals
are structured records, written once per run from the device-side FrameLog.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: dict[str, Any]):
        record = {"ts": time.time(), **record}
        line = json.dumps(record, default=_np_default)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


def log_frame_logs(logger: MetricsLogger, logs, prefix: str = "frame"):
    """Expand a stacked FrameLog into per-frame JSONL records.

    Each field is pulled from the device ONCE up front — per-element pulls
    are a device sync each.
    """
    fields = {
        "num_inliers": np.asarray(logs.num_inliers),
        "chi_inliers": np.asarray(logs.chi_inliers),
        "iterations": np.asarray(logs.iterations),
        "converged": np.asarray(logs.converged),
        "n_map_matches": np.asarray(logs.n_map_matches),
        "n_map_correct": np.asarray(logs.n_map_correct),
        "n_frame_matches": np.asarray(logs.n_frame_matches),
        "n_new_points": np.asarray(logs.n_new_points),
        "map_count": np.asarray(logs.map_count),
        "n_dropped_candidates": np.asarray(logs.n_dropped_candidates),
        "n_dropped_overflow": np.asarray(logs.n_dropped_overflow),
    }
    n = len(fields["num_inliers"])
    for i in range(n):
        rec = {"event": prefix, "frame": i + 1}
        rec.update({k: v[i].item() for k, v in fields.items()})
        logger.log(rec)
