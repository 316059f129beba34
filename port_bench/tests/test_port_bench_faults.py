"""A run whose timed path is broken underneath reports ``correct`` false:
the harness is driven past its look for a card, on the CPU at a small
size, with the program faulted where it produces its answer.  (No cell
runs across chips, so no exchange between chips can be left out.)"""

import pytest
import torch

from port_bench.tests import tiny


def _faulty_steps(monkeypatch, fault):
    from text2nerf_tpu_torch.engine import train_step as ts

    real = ts.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        opt = args[1]

        def broken(state, aabb, batch, rng=None, tv_decay=None, alpha_mask=None, lr_decay=1.0,
                   jitter=None, bg_coin=None):
            if fault == "half_batch":
                half = batch["rays"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
                jitter = jitter[:half]
                return step(state, aabb, batch, rng, tv_decay, alpha_mask, lr_decay, jitter,
                            bg_coin)
            params = [p for g in opt.param_groups for p in g["params"]]
            before = [p.detach().clone() for p in params]
            _, metrics = step(state, aabb, batch, rng, tv_decay, alpha_mask, lr_decay, jitter,
                              bg_coin)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return state, metrics  # the state it was given

        return broken

    monkeypatch.setattr(ts, "make_train_step", make)


@pytest.mark.parametrize("workload", [tiny.DENSE_CELL, tiny.CP_CELL,
                                      "vmsplit_300.train_compact"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_is_not_correct(monkeypatch, workload, fault):
    c = tiny.cell(workload)
    assert tiny.run(c)["correct"] is True
    _faulty_steps(monkeypatch, fault)
    out = tiny.run(c)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def test_an_altered_frame_is_not_correct(monkeypatch):
    from text2nerf_tpu_torch.engine import renderer

    c = tiny.cell("vmsplit_300.render_view")
    assert tiny.run(c)["correct"] is True
    real = renderer.render_view
    chunk = c["traffic"]["render"]["chunk"]

    def altered(*args, **kwargs):
        rgb, depth = real(*args, **kwargs)
        flat = rgb.reshape(-1, 3)
        flat[:chunk] = 1.0 - flat[:chunk]  # one chunk's answer altered where it is made
        return rgb, depth

    monkeypatch.setattr(renderer, "render_view", altered)
    out = tiny.run(c)
    assert out["correct"] is False
