"""What blocks a CUDA graph capture, checked on the CPU: every aten op that
the compiled steps' bodies dispatch, recorded by a ``TorchDispatchMode`` on
their second call (the first fills the constant caches), with
``ops.linalg.eigh`` on the card's route (the Jacobi sweeps; on CPU tensors
it is LAPACK by design).

None of these may appear: ``_local_scalar_dense`` (a value read back to
the host), ``_linalg_check_errors`` (a solver's status read back),
``linalg_eigh`` / ``_linalg_eigh`` / ``linalg_eigvalsh`` (which read theirs),
``nonzero`` and ``masked_select`` (their output's size comes from the
device) and ``lift_fresh`` (a tensor built from host values in the call,
which on a card is a copy from pageable memory).

Also the compiled steps' cache (``models/pipeline._compiled``) with a
stand-in for the CUDA graph: its keys and its eviction order.
"""

from __future__ import annotations

import collections
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, RegistrationConfig
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.ops import linalg
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

torch.set_num_threads(1)

FORBIDDEN = {"_local_scalar_dense", "_linalg_check_errors", "linalg_eigh", "_linalg_eigh", "linalg_eigvalsh",
             "nonzero", "masked_select", "lift_fresh"}


class OpRecorder(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, and the port's source line
    of every forbidden one."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        self.ops[name] += 1
        if name in FORBIDDEN:
            frames = [f for f in traceback.extract_stack() if "cylinder_pose_estimation_tpu_torch" in f.filename]
            where = f"{frames[-1].filename.rsplit('cylinder_pose_estimation_tpu_torch', 1)[-1]}:{frames[-1].lineno}" \
                if frames else "?"
            self.sites[(name, where)] += 1
        return func(*args, **(kwargs or {}))


def _second_call(fn):
    fn()
    rec = OpRecorder()
    with rec:
        fn()
    return rec


@pytest.fixture(scope="module")
def scene():
    st, (a, b) = example_pair(240, 320, 2)
    return stereo_from_numpy(*st, device="cpu"), torch.as_tensor(a), torch.as_tensor(b)


@pytest.fixture
def card_route(monkeypatch):
    monkeypatch.setattr(linalg, "_lapack", lambda t: False)


@pytest.mark.parametrize("branch", ["kernels", "xla"])
def test_batch_step_is_capture_clean(scene, card_route, branch):
    stereo, a, b = scene
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=branch == "kernels")
    rec = _second_call(lambda: pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig()))
    assert not rec.sites, dict(rec.sites)
    assert sum(rec.ops.values()) > 1000  # the recorder saw the step


def test_summary_and_registration_are_capture_clean(scene, card_route):
    stereo, a, b = scene
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    batch = pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig())
    rec = _second_call(lambda: pipeline._summarize_batch(batch, RegistrationConfig()))
    assert not rec.sites, dict(rec.sites)
    angles = torch.as_tensor(np.array([[0.1, 0.02], [-0.1, -0.03]], np.float32))
    rec = _second_call(lambda: pipeline.register_sequence(batch, angles))
    assert not rec.sites, dict(rec.sites)
    assert rec.ops["bmm"] + rec.ops["mm"] > 100


def test_recorder_sees_each_forbidden_kind():
    """The recorder flags what it must: a scalar read back, LAPACK's eigh,
    a host-built tensor, a data-sized output."""
    x = torch.arange(6.0).reshape(2, 3)
    rec = OpRecorder()
    with rec:
        float(x.sum())
        torch.linalg.eigh(x.T @ x)
        torch.tensor([1.0, 2.0])
        torch.nonzero(x)
    seen = {name for name, _ in rec.sites}
    assert {"_local_scalar_dense", "lift_fresh", "nonzero"} <= seen
    assert seen & {"linalg_eigh", "_linalg_eigh"}


class _FakeGraph:
    """Stands in for ``_GraphStep`` on the CPU: runs the body eagerly."""

    made = 0

    def __init__(self, fn, inputs):
        type(self).made += 1
        self.fn = fn

    def __call__(self, *inputs):
        return self.fn(*inputs)


def test_compiled_cache_keys_and_evicts_oldest(monkeypatch):
    """One entry per key and input shape, dtype and device, with no graph
    until its second call (the first is the eager call); at
    ``_STREAM_STEP_CACHE_SIZE`` entries the oldest goes first."""
    monkeypatch.setattr(pipeline, "_GraphStep", _FakeGraph)
    monkeypatch.setattr(pipeline, "_graphs", lambda t: True)
    monkeypatch.setattr(pipeline, "_STREAM_STEP_CACHE", collections.OrderedDict())
    _FakeGraph.made = 0
    cap = pipeline._STREAM_STEP_CACHE_SIZE
    assert 1 < cap < 16  # JAX's cache holds 16

    def body(x):
        return x + 1

    x = torch.zeros(3)
    assert torch.equal(pipeline._compiled(("k",), body, (x,)), x + 1)
    assert _FakeGraph.made == 0 and list(pipeline._STREAM_STEP_CACHE.values()) == [None]
    assert torch.equal(pipeline._compiled(("k",), body, (x + 5,)), x + 6)
    pipeline._compiled(("k",), body, (x + 7,))
    assert _FakeGraph.made == 1  # same key, shape, dtype, device
    for made, other in ((1, torch.zeros(4)), (2, torch.zeros(3, dtype=torch.float64))):
        pipeline._compiled(("k",), body, (other,))
        assert _FakeGraph.made == made
        pipeline._compiled(("k",), body, (other,))
        assert _FakeGraph.made == made + 1
    pipeline._compiled(("fresh",), lambda t: (t,), (x,), fresh=True)
    fresh = pipeline._compiled(("fresh",), lambda t: (t,), (x,), fresh=True)
    assert torch.equal(fresh[0], x) and fresh[0].data_ptr() != x.data_ptr()
    for i in range(cap):
        pipeline._compiled(("other", i), body, (x,))
    assert len(pipeline._STREAM_STEP_CACHE) == cap
    keys = list(pipeline._STREAM_STEP_CACHE)
    assert keys[0][:2] == ("other", 0) and keys[-1][:2] == ("other", cap - 1)


def test_compiled_batch_on_the_cpu_is_the_eager_call(scene):
    """On CPU tensors ``compiled_batch`` is ``estimate_poses_batch`` and
    captures nothing; the stream step likewise."""
    stereo, a, b = scene
    cfg = CylinderDetectConfig(height=240, width=320, use_pallas=True)
    before = len(pipeline._STREAM_STEP_CACHE)
    got = pipeline.compiled_batch(stereo, cfg, FitConfig(), probe="detect")(a, b)
    want = pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig(), probe="detect")
    for g, w in zip(pipeline._tree_leaves(got), pipeline._tree_leaves(want)):
        assert torch.equal(g, w)
    summary = pipeline._stream_step(stereo, cfg, FitConfig(), RegistrationConfig(), True)(a, b)
    assert torch.equal(summary.params, pipeline.estimate_poses_batch(a, b, stereo, cfg, FitConfig()).fit.params)
    assert len(pipeline._STREAM_STEP_CACHE) == before


def test_tree_map_keeps_plain_tuples():
    out = pipeline._tree_map(lambda t: t * 2, (torch.ones(1), (torch.ones(2), torch.zeros(1))))
    assert type(out) is tuple and type(out[1]) is tuple and torch.equal(out[1][0], torch.full((2,), 2.0))
