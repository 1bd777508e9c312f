"""The trace arithmetic on a small synthetic Chrome trace."""
import json

import pytest

from perfbench import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _x("user_annotation", "pb.collect", 0, 100),
    _x("user_annotation", "pb.update", 100, 100),
    _x("user_annotation", "pb.inner", 120, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 125, 2, correlation=3),
    _x("cuda_driver", "cuLaunchKernel", 250, 2, correlation=4),
    _x("kernel", "k_a", 20, 50, correlation=1),
    _x("kernel", "k_b", 60, 40, correlation=2),      # overlaps k_a
    _x("gpu_memcpy", "Memcpy DtoD", 130, 10, correlation=3),
    _x("kernel", "k_a", 260, 30, correlation=4),     # launched outside
    _x("kernel", "k_c", 300, 5, correlation=99),     # launch not traced
    _x("gpu_user_annotation", "pb.collect", 20, 80),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
]


def test_busy_is_the_union_of_device_intervals():
    # [20, 100] + [130, 140] + [260, 290] + [300, 305]
    assert trace.busy_us(EVENTS) == 80 + 10 + 30 + 5


def test_each_operation_goes_to_its_launching_span():
    names = ["pb.collect", "pb.update", "pb.inner"]
    got = trace.attribute(EVENTS, names)
    assert got["pb.collect"] == pytest.approx(50e-6)
    assert got["pb.update"] == pytest.approx(40e-6)
    assert got["pb.inner"] == pytest.approx(10e-6)
    assert got[None] == pytest.approx(35e-6)
    only = trace.attribute(EVENTS, ["pb.update"])
    assert only["pb.update"] == pytest.approx(50e-6)


def test_breakdown_ranks_operations_and_idle_gaps(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    events = trace.load(path)
    bd = trace.breakdown(events, ["pb.collect", "pb.update", "pb.inner"],
                         top=2)
    assert bd["device_ops"] == [["k_a", pytest.approx(80e-6)],
                                ["k_b", pytest.approx(40e-6)]]
    # gaps by where the host was as each began: 100-130 in update (which
    # opens as collect closes), 140-260 in inner (closing at 140), 290-300
    # outside every span; the two longest kept
    assert dict(bd["idle_gaps"]) == {"pb.inner": pytest.approx(120e-6),
                                     "pb.update": pytest.approx(30e-6)}
    assert dict(trace.breakdown(events, ["pb.update"])["idle_gaps"]) == {
        "pb.update": pytest.approx(150e-6), "outside": pytest.approx(10e-6)}
