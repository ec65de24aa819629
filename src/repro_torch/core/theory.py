"""Probes for the paper's theory (counterpart of `repro/core/theory.py`):
Theorem 1 (gradient variance against temporal batch size) and Theorem 2
(the convergence-rate bound). `benchmarks/thm1_variance.py` reads the
JAX version's."""
from __future__ import annotations

import numpy as np

from repro_torch.utils.tree import tree_leaves


def epoch_gradient(epoch_fn, params, stream_batches, neg_generator):
    """The whole-epoch gradient sum_i grad L_i(theta^(i-1)) under one
    negative-sampling draw: `epoch_fn(params, batches, generator)` returns
    (gradient tree, aux)."""
    return epoch_fn(params, stream_batches, neg_generator)


def gradient_variance(grads: list) -> float:
    """Empirical Var[grad L(theta)] over negative-sampling draws: the mean
    over draws of the squared distance to the mean gradient, summed over
    the leaves (Theorem 1's left side). `grads`: gradient trees (dicts of
    tensors or arrays)."""
    flat = [np.concatenate([np.ravel(_np(g)) for g in tree_leaves(gr)])
            for gr in grads]
    stack = np.stack(flat)
    mean = stack.mean(axis=0, keepdims=True)
    return float(np.mean(np.sum((stack - mean) ** 2, axis=1)))


def _np(g):
    return g.detach().cpu().numpy() if hasattr(g, "detach") else \
        np.asarray(g)


def theorem1_lower_bound(n_events: int, batch_size: int,
                         sigma_min_sq: float):
    """(|E| / b) * sigma_min^2."""
    return n_events / batch_size * sigma_min_sq


def theorem2_bound(K: int, L: float, mu: float, loss_gap: float,
                   sigma_max_sq: float, T: int):
    """The right side of Eq. 6 (up to constants): the convergence-rate
    estimate."""
    return (2 * np.sqrt(K) * L * loss_gap / mu ** 2
            + np.sqrt(K) * sigma_max_sq * np.log(max(T, 2))) / np.sqrt(T)
