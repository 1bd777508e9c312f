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
    assert registry() == ("supplychain-linear-v0", "supplychain-ntom-v0",
                          "supplychain-2perstage-v0", "sc-2perstage-v0",
                          "sc-2perstage-multiproduct-v0",
                          "sc-Nperstage-multiproduct-v0",
                          "sc-2perstage-multiproduct-inccosts-v0",
                          "beergame-v0", "supplychain-v0",
                          "sc-2perstage-seasonal-v0",
                          "sc-2perstage-multiproduct-v1",
                          "sc-2perstage-multiproduct-inccosts-v1",
                          "supplychain-oneonen-v0")
    # every id of the JAX registry but the beer game's v2
    assert set(jsct.registry()) - set(registry()) == {"beergame-v2"}
    spec = make_chain("beergame-v0")
    assert (spec.levels, spec.weeks, spec.delay) == (4, 35, 2)
    assert list(spec.demand) == [4] * 4 + [8] * 31
    with pytest.raises(KeyError):
        make_chain("supplychain-v9")
