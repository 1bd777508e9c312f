"""The port's vendored topology compiler equals the JAX package's.

``gym_supplychain_tpu_torch/core/compile.py`` is a copy of the numpy-only
``gym_supplychain_tpu/core/compile.py`` (importing the original would import
jax).  Both compile the same ``nodes_info`` here and every ``CompiledChain``
field must match, for the slice's presets and for the chains of
``tests/fixture_scenarios.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gym_supplychain_tpu as jsct  # noqa: E402
from gym_supplychain_tpu.envs import single as jax_single  # noqa: E402

from gym_supplychain_tpu_torch import make_chain, registry  # noqa: E402
from gym_supplychain_tpu_torch.core.compile import compile_chain  # noqa: E402

from .fixture_scenarios import SC_SCENARIOS  # noqa: E402
from .utils import simple_chain  # noqa: E402


def _assert_chains_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "demand":
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b]
        else:
            assert a == b, f.name


@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0",
                                    "supplychain-2perstage-v0",
                                    "sc-2perstage-v0",
                                    "sc-2perstage-multiproduct-v0",
                                    "sc-Nperstage-multiproduct-v0",
                                    "sc-2perstage-multiproduct-inccosts-v0",
                                    "sc-2perstage-seasonal-v0",
                                    "sc-2perstage-multiproduct-v1",
                                    "sc-2perstage-multiproduct-inccosts-v1",
                                    "supplychain-oneonen-v0"])
@pytest.mark.parametrize("T", [360, 20])
def test_slice_presets_match_jax(env_id, T):
    _assert_chains_equal(make_chain(env_id, total_time_steps=T),
                         jsct.make(env_id, total_time_steps=T).cc)


@pytest.mark.parametrize("name", sorted(SC_SCENARIOS))
def test_vendored_compile_matches_jax_on_fixture_chains(name, monkeypatch):
    calls = []
    original = jax_single.compile_chain

    def spy(*args, **kw):
        cc = original(*args, **kw)
        calls.append((args, kw, cc))
        return cc

    monkeypatch.setattr(jax_single, "compile_chain", spy)
    SC_SCENARIOS[name]["build"](None)
    assert calls, "the scenario compiled no chain"
    for args, kw, want in calls:
        _assert_chains_equal(compile_chain(*args, **kw), want)


def test_registry_and_beergame_spec():
    # the registries of make_chain and make are the JAX registry, in order
    assert registry() == jsct.registry()
    import gym_supplychain_tpu_torch as sct
    for env_id in registry():
        kw = {"nodes_info": simple_chain()} if env_id == "supplychain-v0" else {}
        make_chain(env_id, **kw)
        assert (type(sct.make(env_id, device="cpu", **kw)).__name__
                == type(jsct.make(env_id, **kw)).__name__), env_id
    spec = make_chain("beergame-v0")
    assert (spec.levels, spec.weeks, spec.delay) == (4, 35, 2)
    assert list(spec.demand) == [4] * 4 + [8] * 31
    assert not spec.v2
    # beergame-v2 field by field against the JAX BeerGameEnv2's defaults
    v2, ref = make_chain("beergame-v2"), jsct.make("beergame-v2")
    assert v2.v2 and (v2.levels, v2.weeks) == (ref.levels, ref.max_weeks)
    assert list(v2.demand) == list(ref.customer_demand)
    assert [2] + [v2.delay] * v2.weeks == list(ref.shipment_delays)
    assert [v2.init_inv] * v2.levels == list(ref.initial_inventory)
    assert (v2.init_ship, v2.init_orders, v2.inv_cost, v2.backlog_cost,
            v2.max_stock, v2.exceeded_capacity_penalty) == (
        ref.initial_shipment_value, ref.initial_orders_value, ref.inv_cost,
        ref.backlog_cost, ref.max_stock, ref.exceeded_capacity_penalty)
    assert [v2.max_order] * v2.levels == list(ref.action_space.nvec)
    with pytest.raises(KeyError):
        make_chain("supplychain-v9")
    with pytest.raises(KeyError):
        sct.make("supplychain-v9")
