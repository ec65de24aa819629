"""Average precision of positive against negative scores (a frozen copy
of the port's `utils/metrics.py::average_precision`)."""
from __future__ import annotations

import numpy as np


def average_precision(pos_scores, neg_scores) -> float:
    scores = np.concatenate([np.asarray(pos_scores), np.asarray(neg_scores)])
    labels = np.concatenate([np.ones(len(pos_scores)),
                             np.zeros(len(neg_scores))])
    labels = labels[np.argsort(-scores, kind="stable")]
    tp = np.cumsum(labels)
    precision = tp / np.arange(1, len(labels) + 1)
    denom = labels.sum()
    if denom == 0:
        return 0.0
    return float(np.sum(precision * labels) / denom)
