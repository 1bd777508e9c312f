"""Each cell's control (the reference in the precision below the
configured one, put in the program's place) fails the cell's limits: on
three seeds, at a size a test run holds (the evaluation's at its own).
TF32 exists on the card alone, so the training and evaluation controls
run there (``cuda``)."""
import types

import pytest
import torch

from perfbench import run
from perfbench.drivers import collect, evaluate, train

SEEDS = (2 ** 31 + 11, 2 ** 31 + 222, 2 ** 31 + 3333)


def _ctx(cell, seed, device, config, traffic):
    _, cfg, tr, _, _ = run.load_cell(cell)
    return types.SimpleNamespace(config={**cfg, **config},
                                 traffic={**tr, **traffic}, seed=seed,
                                 device=device, spans=None), tr["limits"]


def _fails(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_collection_fails(seed):
    ctx, limits = _ctx("ntom-collect", seed, "cpu", {"horizon": 40},
                       {"batch": 64})
    assert _fails(collect.control(ctx), limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_training_fails(seed, card):
    ctx, limits = _ctx("ntom-train", seed, card, {"horizon": 60},
                       {"batch": 256})
    assert _fails(train.control(ctx), limits)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_evaluation_fails(seed, card):
    # at the cell's own size: TF32 moves a shorter, narrower episode's
    # returns less (1.8e-6 at B = 512, T = 60 on one seed)
    ctx, limits = _ctx("ntom-eval", seed, card, {}, {})
    assert _fails(evaluate.control(ctx), limits)
