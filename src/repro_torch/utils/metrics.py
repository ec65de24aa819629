"""Evaluation metrics (numpy copies of `repro/utils/metrics.py`)."""
from __future__ import annotations

import numpy as np


def average_precision(pos_scores, neg_scores) -> float:
    """AP for binary ranking: positives vs negatives."""
    scores = np.concatenate([np.asarray(pos_scores), np.asarray(neg_scores)])
    labels = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tp = np.cumsum(labels)
    precision = tp / np.arange(1, len(labels) + 1)
    denom = labels.sum()
    if denom == 0:
        return 0.0
    return float(np.sum(precision * labels) / denom)


def roc_auc(pos_scores, neg_scores) -> float:
    """ROC-AUC via the Mann-Whitney U statistic with averaged tie ranks."""
    pos = np.asarray(pos_scores)
    neg = np.asarray(neg_scores)
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    all_scores = np.concatenate([pos, neg])
    ranks = np.empty(len(all_scores))
    order = np.argsort(all_scores, kind="stable")
    sorted_scores = all_scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))
