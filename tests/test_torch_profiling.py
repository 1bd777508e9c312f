"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Off, a span is one shared object that records nothing, enters no
``record_function`` and reads no clock; on, it keeps its name, its parent
and its host times in a bounded store and lands in a running
``torch.profiler`` trace as a ``gsc.*`` user annotation.  The counters are
one registry.  The fused trainer's and the fused evaluator's CPU runs show
their spans nested in a Chrome trace written by ``trace``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from gym_supplychain_tpu_torch import make_chain  # noqa: E402
from gym_supplychain_tpu_torch.learn.evaluate import (  # noqa: E402
    make_fused_evaluator)
from gym_supplychain_tpu_torch.learn.ppo import (PPOConfig,  # noqa: E402
                                                 make_ppo_fused)
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    ActorCritic, MLPConfig)
from gym_supplychain_tpu_torch.ops._mlp import MlpLayout  # noqa: E402
from gym_supplychain_tpu_torch.utils import profiling as prof  # noqa: E402

HIDDEN = (16, 16)


@pytest.fixture(autouse=True)
def clean():
    """Each test starts and ends with the spans off, no records and no
    counts."""
    prof.enable(False)
    prof.take()
    prof.reset_counters()
    yield
    prof.enable(False)
    prof.take()
    prof.reset_counters()


def test_off_hands_back_one_noop_and_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("touched while the spans are off")

    monkeypatch.setattr(prof, "record_function", refuse)
    monkeypatch.setattr(prof, "perf_counter_ns", refuse)
    assert not prof.enabled()
    a, b = prof.span("x"), prof.span("y")
    assert a is b
    with a:
        with b:
            pass
    assert prof.take() == []
    assert prof.counters() == {}


def test_on_records_nesting_and_parents():
    assert prof.enable(True) is False
    assert prof.enabled()
    with prof.span("outer"):
        with prof.span("inner"):
            with prof.span("leaf"):
                pass
        with prof.span("inner"):
            pass
    records = prof.take()
    assert [(r.name, r.parent) for r in records] == [
        ("leaf", "inner"), ("inner", "outer"), ("inner", "outer"),
        ("outer", None)]
    assert all(r.end_ns >= r.start_ns for r in records)
    leaf, first, second, outer = records
    assert first.start_ns <= leaf.start_ns and leaf.end_ns <= first.end_ns
    assert outer.start_ns <= first.start_ns and second.end_ns <= outer.end_ns
    assert prof.enable(False) is True


def test_a_span_closes_when_its_block_raises():
    prof.enable(True)
    with pytest.raises(ValueError):
        with prof.span("outer"):
            with prof.span("inner"):
                raise ValueError("inside")
    with prof.span("after"):
        pass
    assert [(r.name, r.parent) for r in prof.take()] == [
        ("inner", "outer"), ("outer", None), ("after", None)]


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 4)
    prof.enable(True)
    for i in range(7):
        with prof.span(f"s{i}"):
            pass
    assert [r.name for r in prof.take()] == ["s3", "s4", "s5", "s6"]
    assert prof.counters() == {"spans.dropped": 3}


def test_take_clears():
    prof.enable(True)
    with prof.span("a"):
        pass
    assert [r.name for r in prof.take()] == ["a"]
    assert prof.take() == []


def test_the_counter_registry():
    prof.count("launch.k")
    prof.count("launch.k", 2)
    prof.count("ops.pack")
    got = prof.counters()
    assert got == {"launch.k": 3, "ops.pack": 1}
    got["launch.k"] = 0                       # a copy
    assert prof.counters()["launch.k"] == 3
    prof.reset_counters()
    assert prof.counters() == {}


def test_counters_count_with_the_spans_off():
    assert not prof.enabled()
    layout = MlpLayout(5, 3, HIDDEN)
    net = ActorCritic(MLPConfig(5, 3, HIDDEN),
                      torch.Generator().manual_seed(0), "cpu")
    layout.pack(net.flat())
    layout.pack(net.flat())
    assert prof.counters() == {"ops.pack": 2}
    assert prof.take() == []


def _user_spans(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _inside(spans, inner, outer):
    """Every span named ``inner`` lies in one named ``outer``."""
    outers = [(a, b) for a, b, n in spans if n == outer]
    inners = [(a, b) for a, b, n in spans if n == inner]
    return bool(inners) and all(any(oa <= a and b <= ob for oa, ob in outers)
                                for a, b in inners)


def _runs():
    """One fused-trainer iteration and one fused evaluation on the CPU."""
    cc = make_chain("supplychain-ntom-v0", total_time_steps=6)
    init_fn, train_step = make_ppo_fused(
        cc, 8, PPOConfig(hidden=HIDDEN, epochs=1, fused_update=True),
        device="cpu")
    evaluate = make_fused_evaluator(cc, 8, HIDDEN, device="cpu")
    state = init_fn(0)

    def run():
        train_step(state)
        evaluate(state.params, 3)

    return run


def test_trace_carries_the_trainer_and_evaluator_spans(tmp_path):
    run = _runs()
    with prof.trace(str(tmp_path)):
        assert prof.enabled()
        run()
    assert not prof.enabled()
    spans = _user_spans(tmp_path / "trace.rank0.json")
    names = {n for _, _, n in spans}
    for name in ("ppo.collect", "ops.collect", "ppo.prepare", "ppo.gae",
                 "ppo.normalize", "ppo.update", "ppo.grads",
                 "ops.ppo_update", "ppo.clip", "ppo.adam", "evaluate",
                 "rng.episode_tables", "ops.policy_rollout"):
        assert "gsc." + name in names, name
    assert _inside(spans, "gsc.ppo.gae", "gsc.ppo.prepare")
    assert _inside(spans, "gsc.ppo.normalize", "gsc.ppo.prepare")
    assert _inside(spans, "gsc.ops.collect", "gsc.ppo.collect")
    assert _inside(spans, "gsc.ops.ppo_update", "gsc.ppo.grads")
    assert _inside(spans, "gsc.ppo.grads", "gsc.ppo.update")
    assert _inside(spans, "gsc.rng.episode_tables", "gsc.evaluate")
    assert _inside(spans, "gsc.ops.policy_rollout", "gsc.evaluate")
    kept = {(r.name, r.parent) for r in prof.take()}
    assert ("ppo.gae", "ppo.prepare") in kept
    assert ("rng.episode_tables", "evaluate") in kept


def test_spans_off_leave_no_program_event_in_a_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    run = _runs()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        run()
    path = tmp_path / "off.json"
    p.export_chrome_trace(str(path))
    assert not [n for _, _, n in _user_spans(path) if n.startswith("gsc.")]
    assert prof.take() == []


def test_trace_restores_the_switch(tmp_path):
    prof.enable(True)
    with prof.trace(str(tmp_path)):
        pass
    assert prof.enabled()
    prof.enable(False)
    with prof.trace(None):
        assert not prof.enabled()
