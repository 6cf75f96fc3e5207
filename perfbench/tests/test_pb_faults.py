"""A run with the timed path broken underneath it comes out not correct:
a frame or step that returns the previous one's answer (its state
unchanged), half of the frame left out (the step's mean taken over the
other half), and an answer altered where it is produced (a step's
per-triangle gradients too: negated, or two components swapped). (One card: no
exchange between cards to leave out.)"""

import pytest

import snail_tpu_torch.diff as diff
import snail_tpu_torch.render.renderer as renderer
from perfbench import harness

from .conftest import BENCH, SEED, run_tiny, tiny_spec

CELLS = {k: [w["name"] for w in BENCH["workloads"]
             if harness.load_json(harness.HERE / "traffic"
                                  / f"{w['traffic']}.json")["kind"] == k]
         for k in ("frame", "step")}


def _stale(fn):
    last = []

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return wrapped


def _half_frame(fn):
    def wrapped(*args, **kw):
        img = fn(*args, **kw).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return wrapped


def _altered_rgb8(fn):
    def wrapped(img):
        out = fn(img).copy()
        out[..., 0] = (out[..., 0].astype(int) + 4).clip(0, 255)
        return out
    return wrapped


def _half_step(fn, target):
    """The step's mean over the first half of the image's rows alone."""
    def wrapped(render_fn, params, loss_fn):
        half = target.shape[0] // 2
        return fn(lambda p: render_fn(p)[:half], params,
                  lambda img: ((img - target[:half]) ** 2).mean())
    return wrapped


def _altered_step(fn):
    def wrapped(*args, **kw):
        loss, grads = fn(*args, **kw)
        return loss, {**grads, "light_pos": -grads["light_pos"]}
    return wrapped


FRAME_FAULTS = {
    "stale": ("render_frame", _stale),
    "half": ("render_frame", _half_frame),
    "altered": ("to_rgb8", _altered_rgb8),
}
def _tri_grads(change):
    """A step whose per-triangle gradients come out changed by ``change``."""
    def breaker(fn, target):
        def wrapped(*args, **kw):
            loss, grads = fn(*args, **kw)
            return loss, {**grads, "tri_ba": change(grads["tri_ba"])}
        return wrapped
    return breaker


STEP_FAULTS = {
    "stale": lambda fn, target: _stale(fn),
    "half": _half_step,
    "altered": lambda fn, target: _altered_step(fn),
    "tri_sign": _tri_grads(lambda g: -g),
    "tri_swap": _tri_grads(lambda g: g[:, [1, 0, 2]]),
}


@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
@pytest.mark.parametrize("workload", CELLS["frame"])
def test_frame_fault_is_not_correct(workload, fault, cache, monkeypatch):
    name, breaker = FRAME_FAULTS[fault]
    monkeypatch.setattr(renderer, name, breaker(getattr(renderer, name)))
    res = run_tiny(tiny_spec(workload), cache)
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
@pytest.mark.parametrize("workload", CELLS["step"])
def test_step_fault_is_not_correct(workload, fault, cache, monkeypatch):
    spec = tiny_spec(workload)
    target = harness.target_image(spec["traffic"], SEED, "cpu")
    monkeypatch.setattr(diff, "render_loss_and_grads", STEP_FAULTS[fault](
        diff.render_loss_and_grads, target))
    res = run_tiny(spec, cache)
    assert not res["correct"], res["checked"]
