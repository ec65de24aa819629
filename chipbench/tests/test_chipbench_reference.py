"""The reference against the port's plain route at a tiny size on the
CPU (every compared number within its limit), and the check's faults:
the timed path broken underneath, `correct` comes out false."""
from __future__ import annotations

import pytest
import torch

from chipbench.drivers import train
from chipbench.tests.conftest import tiny

TRAIN_CELLS = ["train-tgl-pres-b2400", "train-tgl-std-b600"]
SEED = 2**31 + 77


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_cell_agrees_with_the_reference(name):
    result, checks = train.run(tiny(name), SEED, 0.2, False, "cpu")
    assert result["correct"], checks
    assert checks["loss_gap"]["value"] < 1e-6
    assert result["metrics"]["train_events_per_s"]["value"] > 0


def test_traced_train_run_reads_the_host_layers():
    result, _ = train.run(tiny("train-tgl-pres-b2400"), SEED, 0.2, True,
                          "cpu")
    assert result["correct"]
    assert {"step_host_ms.train", "train_mfu"} <= set(result["metrics"])
    # no device: no roofline is made up
    assert "embed_attn_roofline.train" not in result["metrics"]


def _no_update(monkeypatch):
    """A step that returns its state unchanged: no update applied."""
    from repro_torch.train import loop
    monkeypatch.setattr(loop, "apply_updates", lambda params, updates: params)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.train import loop
    bce = loop.link_bce

    def half(lp, ln, pm, nm):
        keep = torch.arange(pm.shape[0], device=pm.device) < pm.shape[0] // 2
        return bce(lp, ln, pm * keep, nm * keep)

    monkeypatch.setattr(loop, "link_bce", half)


def _eager(monkeypatch):
    """Every step runs eagerly, as it does on the card where its graph
    cannot be captured (a reason in `eager_reason`)."""
    from repro_torch.train import capture
    eager = capture.CapturedStep.eager

    def planted(self, *a, **kw):
        out = eager(self, *a, **kw)
        self.eager_reason = "planted"
        return out

    monkeypatch.setattr(capture.CapturedStep, "eager", planted)


def _grad_doubled(monkeypatch):
    """A backward wrong in magnitude: every gradient twice what it is.
    AdamW's update does not change when a leaf's gradient is scaled, so
    only the first gradient's numbers see it."""
    from repro_torch.optim import optimizers
    adamw = optimizers.adamw

    def doubled(lr, **kw):
        inner = adamw(lr, **kw)

        def update(grads, state, params):
            grads = optimizers.tree_map(lambda g: 2 * g, grads)
            return inner.update(grads, state, params)

        return optimizers.Optimizer(inner.init, update, inner.state_axes)

    monkeypatch.setattr(optimizers, "adamw", doubled)


@pytest.mark.parametrize("fault", [_no_update, _half_batch, _eager,
                                   _grad_doubled],
                         ids=["state-unchanged", "half-batch", "eager",
                              "grad-doubled"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_faults_are_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    result, checks = train.run(tiny(name), SEED, 0.1, False, "cpu")
    assert not result["correct"], checks

