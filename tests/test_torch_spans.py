"""The port's spans and counters (``engine/tracing.py``) on a tiny CPU
field through the plain paths:

- under ``torch.profiler``, ``render_view`` (adaptive, with a mask)
  records ``t2n.view`` around ``t2n.view.base`` / ``need`` / ``escalate``
  / ``out``, and the layer spans inside the chunk and group spans;
- a compacted and a dense train step record ``t2n.step`` around one
  ``t2n.subbatch`` a sub-batch, and the trainer's batch source
  ``t2n.batch``;
- the counters equal a hand count of the view's rays, its escalated rays,
  kernel B's rows and the rays of the plain eval select;
- with no profiler, ``span`` is the shared no-op and nothing is counted,
  and a frame's pixels and a step's metrics and parameters are bit-equal
  to a profiled run's.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from text2nerf_tpu_torch.data import synthetic as syn
from text2nerf_tpu_torch.engine import renderer, tracing
from text2nerf_tpu_torch.engine import train_step as ts
from text2nerf_tpu_torch.engine import trainer as TR
from text2nerf_tpu_torch.models import tensorf as tf
from text2nerf_tpu_torch.ops import rays as R
from text2nerf_tpu_torch.ops import render as Rd

torch.set_num_threads(1)

AABB = torch.tensor(syn.AABB)
HW = 16
#: chunk and ladder small enough that the view takes four chunks and a
#: part of its rays climbs each rung
VIEW_KW = dict(chunk=64, app_k=32, compact_k=-1, k_ladder=(4, 8, 16), feature_dtype="fp32",
               device="cpu")
LAYERS = ("t2n.select", "t2n.features", "t2n.head", "t2n.composite")


@pytest.fixture(autouse=True)
def fresh_counts(monkeypatch):
    """Each test starts with no counts and no memoized base rung (the
    memo is keyed by the field's id, which a new field may reuse)."""
    monkeypatch.setattr(Rd, "_ADAPTIVE_PROBE_CACHE", {})
    tracing.reset_counts()
    yield
    tracing.reset_counts()


def _field(seed=0):
    """The room shell on a 24^3 grid at distance scale 1: the wall's rays
    end between acc 0.997 and 1, so some escalate and some do not."""
    cfg = tf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), distance_scale=1.0)
    reso = tf.n_to_reso(24 ** 3, syn.AABB)
    gen = torch.Generator().manual_seed(seed)
    return syn.room_shell_field(cfg, reso, generator=gen, device="cpu")


def _view():
    field = _field().requires_grad_(False)
    mask, _ = tf.update_alpha_mask(field, AABB, (16, 16, 16), pool=3, device="cpu")
    intr = R.default_intrinsics(HW, HW)
    dirs = R.ray_directions(HW, HW, intr[:2], intr[2:], device="cpu")
    rays = torch.cat(R.rays_from_pose(dirs, syn.serving_poses()[0]), -1).reshape(-1, 6)
    n = tf.default_n_samples(tf.grid_resolution(field), field.cfg.step_ratio)
    return field, mask, rays, n


def _render(view):
    field, mask, rays, n = view
    return renderer.render_view(field, AABB, rays, (HW, HW), n_samples=n, alpha_mask=mask,
                                **VIEW_KW)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _enclosing(evt):
    """The name of the nearest ``t2n.*`` range around a profiler event."""
    e = evt.cpu_parent
    while e is not None and not e.name.startswith("t2n."):
        e = e.cpu_parent
    return e.name if e is not None else None


def _nesting(events):
    """{span name: the set of span names directly around it}."""
    out = {}
    for e in events:
        if e.name.startswith("t2n."):
            out.setdefault(e.name, set()).add(_enclosing(e))
    return out


def test_view_spans_nest():
    _, events = _profiled(lambda: _render(_view()))
    nest = _nesting(events)
    assert nest["t2n.view"] == {None}
    for name in ("t2n.view.base", "t2n.view.need", "t2n.view.escalate", "t2n.view.out"):
        assert nest[name] == {"t2n.view"}, name
    for name in LAYERS:
        assert nest[name] == {"t2n.view.base", "t2n.view.escalate"}, name
    names = [e.name for e in events]
    assert names.count("t2n.view") == 1 and names.count("t2n.view.need") == 1
    assert names.count("t2n.view.base") == HW * HW // VIEW_KW["chunk"]


def _step_setup(compact):
    """(step, state, batch, step kwargs) of a tiny compacted (K 8, one
    sub-batch) or dense (two sub-batches) step."""
    field = _field()
    mask, _ = tf.update_alpha_mask(field, AABB, (16, 16, 16), pool=3, device="cpu")
    n = tf.default_n_samples(tf.grid_resolution(field), field.cfg.step_ratio)
    state, opt = ts.make_train_state(field)
    kw = dict(compact_k=8, app_k=8, microbatch_compact=1) if compact else \
        dict(app_k=8, microbatch=2)
    step = ts.make_train_step(field.cfg, opt, n_samples=n, device="cpu", **kw)
    gen = np.random.default_rng(3)
    b = 32
    d = gen.normal(size=(b, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pool = (np.concatenate([np.zeros((b, 3), np.float32), d], -1),
            gen.uniform(size=(b, 3)).astype(np.float32),
            gen.uniform(3.0, 4.0, size=b).astype(np.float32))
    batch = TR._batch_from_pool(pool, np.arange(b), "cpu")
    jitter = torch.from_numpy(gen.uniform(size=(b, 1)).astype(np.float32))
    return step, state, batch, dict(alpha_mask=mask if compact else None, jitter=jitter)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
def test_train_spans_nest(compact):
    step, state, batch, kw = _step_setup(compact)
    _, events = _profiled(lambda: step(state, AABB, batch, **kw))
    nest = _nesting(events)
    assert nest["t2n.step"] == {None}
    assert nest["t2n.subbatch"] == {"t2n.step"}
    names = [e.name for e in events]
    assert names.count("t2n.step") == 1
    assert names.count("t2n.subbatch") == (1 if compact else 2)
    for name in ("t2n.select", "t2n.features", "t2n.head", "t2n.composite", "t2n.loss"):
        assert nest[name] == {"t2n.subbatch"}, name
    # the regularizers ride in the one sub-batch's backward at R = 1, and
    # follow the sub-batches otherwise
    assert nest["t2n.reg"] == ({"t2n.subbatch"} if compact else {"t2n.step"})
    assert any(e.name.startswith("Optimizer.step") and _enclosing(e) == "t2n.step"
               for e in events)


def test_batch_source_span():
    pool = tuple(np.arange(12 * w, dtype=np.float32).reshape(12, w) for w in (6, 3, 1))
    batch, events = _profiled(lambda: TR._batch_from_pool(pool, np.array([3, 1, 7]), "cpu"))
    assert [e.name for e in events if e.name.startswith("t2n.")] == ["t2n.batch"]
    assert batch["rays"].shape == (3, 6)
    assert not tracing.counts()


def test_counts_match_a_hand_count():
    view = _view()
    _profiled(lambda: _render(view))
    got = tracing.counts()
    field, mask, rays, n = view
    chunk, (k_base, *_) = VIEW_KW["chunk"], VIEW_KW["k_ladder"]
    needs = []
    for s in range(0, rays.shape[0], chunk):
        _, need = Rd.render_rays_compact_need(
            field, AABB, rays[s:s + chunk], mask, n_samples=n, compact_k=k_base, app_k=k_base,
            k_ladder=VIEW_KW["k_ladder"], feature_dtype="fp32")
        needs.append(need)
    need = torch.cat(needs)
    escalated = int((need > 0).sum())
    k_top = VIEW_KW["k_ladder"][int(need.max())]
    groups = -(-escalated // chunk)
    assert 0 < escalated < HW * HW
    assert got == {"view.rays": HW * HW, "view.rays_escalated": escalated,
                   "head.samples": HW * HW * k_base + groups * chunk * k_top,
                   "select.plain_rays": HW * HW + groups * chunk}


def test_no_profiler_no_span_no_count():
    assert tracing.span("t2n.view") is tracing.span("t2n.step")
    with tracing.span("t2n.view") as inner:
        assert inner is None
    _render(_view())
    tracing.count("view.rays", 5)
    assert tracing.counts() == {}


def test_a_profiled_frame_is_bit_equal():
    plain = _render(_view())
    Rd._ADAPTIVE_PROBE_CACHE.clear()
    traced, _ = _profiled(lambda: _render(_view()))
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
def test_a_profiled_step_is_bit_equal(compact):
    def run(traced):
        step, state, batch, kw = _step_setup(compact)
        go = (lambda: step(state, AABB, batch, **kw))
        (state, metrics), _ = _profiled(go) if traced else (go(), None)
        return metrics, [p.detach().clone() for p in state.field.parameters()]

    (m0, p0), (m1, p1) = run(False), run(True)
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
