"""Structured JSONL run logging: one append-only event stream per run,
including the qualitative sample table (query / raw prediction /
post-processed prediction / target / duration)."""

from __future__ import annotations

import json
import os
import time


class RunLogger:
    def __init__(self, output_dir: str, name: str = "run"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self.start = time.time()

    def log(self, event: str, **fields) -> None:
        record = {"event": event, "t": round(time.time() - self.start, 3), **fields}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def log_samples(self, qids, queries, raw_predictions, processed_predictions, targets,
                    durations, split: str = "train") -> None:
        """Qualitative sample rows, one event each."""
        for qid, query, raw, proc, target, dur in zip(
                qids, queries, raw_predictions, processed_predictions, targets, durations):
            self.log("sample", split=split, qid=qid, query=query, raw_prediction=raw,
                     processed_prediction=proc, target=target, duration=dur)

    def close(self) -> None:
        self._f.close()
