"""The counts against the figures the kernel table was measured with
(ntom: 27 obs, 14 actions, 8 nodes, 2 retailers, 14 lead-time columns)."""
import pytest

from perfbench import counts

O, A, N, P, R, K, H = 27, 14, 8, 1, 2, 14, (128, 128)


def _bytes(ms):
    return ms / 1e3 * counts.PEAK_BYTES


def test_k1_random_eight_episodes():
    ms, what = counts.collect_bound(O, N, P, 8 * 360, 4096)
    assert what == "bytes"
    assert _bytes(ms) == pytest.approx(1.32e9, rel=2e-3)
    assert _bytes(ms) == 4 * 4096 * (8 * 360 * 28 + 8)


def test_k1_policy_operations_an_env_step():
    lay = counts.mlp_layout(O, A, H)
    assert 2 * counts.macs(lay, [0, 1]) == 83200
    ms, what = counts.k1_policy_bound(O, A, N, P, H, 60, 4096)
    assert what == "operations"
    assert ms == pytest.approx(0.3052, abs=1e-4)


def test_k2_at_245760_samples():
    M = 245760
    assert counts.k2_flops(O, A, H, M) / 1e9 == pytest.approx(57.9, abs=0.05)
    ms, what = counts.k2_bound(O, A, H, M)
    assert what == "operations"
    assert ms == pytest.approx(0.8648, abs=1e-4)
    n_params = counts.mlp_layout(O, A, H)["n_params"]
    assert 4 * (M * (O + A + 3) + 2 * n_params) / 1e6 == pytest.approx(
        43.6, abs=0.05)


def test_k4_an_episode():
    assert counts.eval_flops(O, A, H, 360, 4096) == pytest.approx(6.38e10,
                                                                  rel=1e-3)
    ms, what = counts.k4_bound(O, A, N, P, R, K, H, 360, 4096)
    assert what == "operations"
    assert ms == pytest.approx(0.9522, abs=1e-4)


def test_an_iteration_of_the_fused_trainer():
    M = 360 * 4096
    assert counts.train_flops(O, A, H, M, 2) / 1e9 == pytest.approx(818.0,
                                                                    abs=1.0)


def test_issue_bound_without_fma():
    lay = counts.mlp_layout(O, A, H)
    n = counts.macs(lay, [0, 1]) * 60 * 4096
    assert counts.issue_bound_ms(n) == pytest.approx(0.6104, abs=1e-4)
