"""``correct``: a sound run passes, the control and each fault a cell can
have fail. On the CPU at the micro size (float32, so the sound run sits far
under the limits the sd15 cell uses); the control at the cell's own size
runs on the card."""
from __future__ import annotations

import json

import pytest
import torch

from cuda_bench import run as R

CPU = torch.device("cpu")


def _verdict(root, cell_name, seed=123, control=False, seconds=1.0):
    cell = R.Cell.load(cell_name, root)
    run = R.measure(cell, seed, seconds, False, CPU, control=control)
    correct, checks = R.verdict(cell, run)
    return correct, checks, run


def _failed(checks):
    return sorted(n for n, c in checks.items() if c["value"] > c["limit"])


def test_sound_sweep_is_correct(micro):
    correct, checks, run = _verdict(micro, "micro-sweep")
    assert correct, checks
    assert run["check"]["rows_checked"] == 2 and run["result"]["attempted"] == 2


def test_control_is_not_correct(micro):
    correct, checks, _ = _verdict(micro, "micro-sweep", control=True)
    assert not correct
    assert {"eps_rel", "grad_rel"} <= set(_failed(checks))


def _alter_images(monkeypatch):
    from guided_attention_tpu_torch.models.bundle import StableDiffusion

    real = StableDiffusion.decode_latents_u8

    def altered(self, latents):
        img = real(self, latents).clone()
        img[:, :8] = 255 - img[:, :8]
        return img
    monkeypatch.setattr(StableDiffusion, "decode_latents_u8", altered)


def _state_unchanged(monkeypatch):
    from guided_attention_tpu_torch import pipeline

    real = pipeline.ddim_step

    def stuck(sched, i, noise_pred, sample, **kw):
        prev, x0 = real(sched, i, noise_pred, sample, **kw)
        return (sample if i == 1 else prev), x0
    monkeypatch.setattr(pipeline, "ddim_step", stuck)


def _half_the_batch(monkeypatch):
    """Row 1 delivered row 0's result: half of the batch left out."""
    from guided_attention_tpu_torch.runner import PendingBatch

    real = PendingBatch.result

    def half(self):
        outs = real(self)
        return outs[: len(outs) // 2] * 2
    monkeypatch.setattr(PendingBatch, "result", half)


def _timestep_shifted(monkeypatch):
    """Every UNet call at the next step's timestep."""
    from guided_attention_tpu_torch import pipeline

    real = pipeline._Loop.unet_eps

    def shifted(self, latents, t, *args, **kw):
        k = min(self.timesteps.index(int(t)) + 1, len(self.timesteps) - 1)
        return real(self, latents, self.timesteps[k], *args, **kw)
    monkeypatch.setattr(pipeline._Loop, "unet_eps", shifted)


def _context_drifts(monkeypatch):
    """The text context altered in the calls after the first step."""
    from guided_attention_tpu_torch import pipeline

    real = pipeline._Loop.unet_eps

    def drifted(self, latents, t, samples, context, *args, **kw):
        if int(t) != self.timesteps[0]:
            context = context * 1.01
        return real(self, latents, t, samples, context, *args, **kw)
    monkeypatch.setattr(pipeline._Loop, "unet_eps", drifted)


@pytest.mark.parametrize("fault", [_alter_images, _state_unchanged, _half_the_batch, _timestep_shifted,
                                   _context_drifts],
                         ids=["answer_altered", "state_unchanged", "half_the_batch", "timestep_shifted",
                              "context_drifts"])
def test_a_fault_is_not_correct(micro, monkeypatch, fault):
    fault(monkeypatch)
    correct, checks, run = _verdict(micro, "micro-sweep")
    assert not correct, checks
    if fault in (_timestep_shifted, _context_drifts):  # the UNet's answers are right for what it was given
        assert _failed(checks) == ["delivery"], checks


def test_serving_delivers_each_request_its_own_row(micro, monkeypatch):
    correct, checks, run = _verdict(micro, "micro-serve", seconds=4.0)
    assert correct, checks
    assert run["result"]["failed"] == 0 and run["check"]["numbers"]["delivery"] == 0

    from guided_attention_tpu_torch.frontends import server

    real = server.BatchingEngine._dispatch

    def swapped(self, group):
        pending = real(self, group)
        outer = pending.result

        def result():
            outs = outer()
            return outs[::-1] if len(group) > 1 else outs
        pending.result = result
        return pending
    monkeypatch.setattr(server.BatchingEngine, "_dispatch", swapped)
    correct, checks, _ = _verdict(micro, "micro-serve", seed=5, seconds=4.0)
    assert not correct and "delivery" in _failed(checks), checks


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sd15-sweep-b8", "sd21-sweep-b8", "sd15-serve-poisson"])
def test_control_fails_at_the_cells_size(card, cell, tmp_path):
    """The control of ``calibrate`` at the cell's own size, three seeds: each
    reading fails at least one limit of the cell's configuration."""
    from cuda_bench import calibrate

    calibrate.main(["--workload", cell, "--seconds", "1", "--control-seeds", "21", "22", "23", "--out", str(tmp_path)])
    limits = R.Cell.load(cell).config["limits"]
    readings = json.loads((tmp_path / f"calibrate_{cell}.json").read_text())
    assert len(readings) == 3
    for r in readings:
        assert any(r["numbers"][n] > limits[n] for n in limits), r
