"""The port's bf16 learner against the JAX package's.

* ``actor_critic_forward(..., compute_dtype=torch.bfloat16)`` (the XLA
  path: bf16 trunks, float32 heads) against JAX's on the same weights:
  ``mu`` and ``value`` at O(1) scale within atol 2e-2 of JAX's op-by-op
  forward, which rounds the trunks' output to bf16 before the heads
  (observed 2.2e-3), and within 1e-6 of its jitted forward, whose XLA:CPU
  graph hands the heads the float32 ``tanh`` as the port does (observed
  2.4e-7, the float32 heads' sum order).
* The plain bf16 update (``ppo_update_plain(..., compute_dtype=bf16)``,
  what ``make_ppo_update_grads(compute_dtype=bf16)`` runs for CPU tensors)
  against the TPU kernel ``make_ppo_update_grads(compute_dtype=bfloat16,
  interpret=True)``: loss rtol 1e-4, flat-gradient cosine >= 0.99999, max
  error <= 5e-3 * max|g| (observed: 3e-8 relative loss, cosine 1 - 2e-13,
  2.1e-6 * max|g|; the products are exact on bf16 operands, so only the
  sums' order differs).
* One ``_make_update`` (2 epochs) of the port against the JAX one on the
  same data, both with ``learner_dtype`` bf16: parameter-delta cosine
  >= 0.999.  Through the update kernel (its plain version against the TPU
  kernel in interpret mode) observed 1 - 2e-11.  Under autograd (the XLA
  path) the port's bf16 trunk rounds where JAX's jitted XLA:CPU graph
  rounds (``models/policy.py``: the bias gradient summed in bf16 in
  XLA:CPU's windows of 32, tanh's derivative rounded op by op, the weight
  gradients and the head's input left in float32): observed 1 - 2e-13,
  and the loss gradients' cosine >= 0.9999 against JAX's op-by-op
  (unjitted) gradient, which rounds at every op (observed 0.9999987).
* The port's form of ``test_ppo_improves_bf16_learner``
  (``tests/test_vector_learn.py``): the bf16 update moves the parameters
  along the float32 one, cosine > 0.9, at the same sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_supplychain_tpu.learn import ppo as jppo  # noqa: E402
from gym_supplychain_tpu.models.policy import (  # noqa: E402
    actor_critic_forward as j_forward)
from gym_supplychain_tpu.ops.ppo_update_pallas import (  # noqa: E402
    make_ppo_update_grads as j_update_grads)

from gym_supplychain_tpu_torch.core.compile import compile_chain  # noqa: E402
from gym_supplychain_tpu_torch.learn import ppo  # noqa: E402
from gym_supplychain_tpu_torch.models.policy import (  # noqa: E402
    actor_critic_forward, params_from_jax)
from gym_supplychain_tpu_torch.ops._mlp import (  # noqa: E402
    LAYOUT_INTS, SMEM_MAX, MlpLayout)
from gym_supplychain_tpu_torch.ops.ppo_update import (  # noqa: E402
    _BF16_INSTANCES, make_ppo_update_grads, ppo_update_bf16_plan)

from . import test_torch_ppo as ppo_tests  # noqa: E402
from .test_torch_ppo import _leaves, _update_data  # noqa: E402
from .utils import simple_chain  # noqa: E402

BF16 = torch.bfloat16


def _tree(O, A, hidden, seed, mu_scale=1.0):
    tree = ppo_tests._tree(O, A, hidden, seed)
    tree["mu"]["w"] = tree["mu"]["w"] * np.float32(mu_scale)
    return tree


def _vec(arrays):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays])


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("hidden", [(32, 32), (16,)])
def test_bf16_forward_matches_jax(hidden):
    O, A, B = 9, 5, 64
    tree = _tree(O, A, hidden, seed=1, mu_scale=50.0)
    obs = np.random.RandomState(2).uniform(-1, 1, (O, B)).astype(np.float32)
    mu, log_std, v = actor_critic_forward(
        params_from_jax(tree, device="cpu"), torch.from_numpy(obs),
        compute_dtype=BF16)
    jmu, jls, jv = j_forward(tree, jnp.asarray(obs),
                             compute_dtype=jnp.bfloat16)
    assert mu.dtype == v.dtype == torch.float32
    assert 0.3 < float(np.abs(np.asarray(jmu)).max()) < 30   # O(1) outputs
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=0,
                               atol=2e-2)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(jls))
    jmu, _, jv = jax.jit(lambda t, o: j_forward(t, o, jnp.bfloat16))(
        tree, jnp.asarray(obs))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6)
    # None keeps the float32 path
    mu32, _, v32 = actor_critic_forward(params_from_jax(tree, device="cpu"),
                                        torch.from_numpy(obs))
    jmu32, _, jv32 = j_forward(tree, jnp.asarray(obs))
    np.testing.assert_allclose(mu32.detach().numpy(), np.asarray(jmu32),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [7, 32, 33, 100, 2048, 40000])
def test_bf16_row_sum_matches_xla(n):
    """The bias gradient's bf16 sum, bit for bit XLA:CPU's bf16 reduction
    (the transpose of the bias broadcast; ``jnp.sum`` would sum in
    float32)."""
    from gym_supplychain_tpu_torch.models.policy import _xla_cpu_row_sum

    x = np.random.RandomState(n).standard_normal((6, n)).astype(np.float32)
    want = jax.jit(lambda a: jax.lax.reduce(
        a, jnp.bfloat16(0), jax.lax.add, (1,)))(jnp.asarray(x, jnp.bfloat16))
    got = _xla_cpu_row_sum(torch.from_numpy(x).to(BF16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("O,A,hidden,M,tile,seed", [
    (6, 3, (32, 32), 256, 128, 0),
    (9, 5, (16,), 128, 64, 4),
])
def test_plain_bf16_update_matches_jax_kernel(O, A, hidden, M, tile, seed):
    tree = _tree(O, A, hidden, seed)
    data = _update_data(tree, O, A, M, seed)
    want_loss, want = j_update_grads(O, A, hidden, M, tile=tile,
                                     compute_dtype=jnp.bfloat16,
                                     interpret=True)(
        tree, *map(jnp.asarray, data))
    gf = make_ppo_update_grads(O, A, hidden, M, compute_dtype=BF16)
    loss, grads = gf(params_from_jax(tree, device="cpu"),
                     *map(torch.from_numpy, data))
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    got, ref = _vec(g.numpy() for g in grads), _vec(_leaves(want))
    assert _cos(got, ref) >= 0.99999
    assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()
    # and it is the bf16 computation: the float32 one differs
    _, g32 = make_ppo_update_grads(O, A, hidden, M)(
        params_from_jax(tree, device="cpu"), *map(torch.from_numpy, data))
    assert np.abs(_vec(g.numpy() for g in g32) - got).max() > 0


@pytest.mark.parametrize("fused_update", [False, True])
def test_update_step_matches_jax_bf16(fused_update):
    O, A, hidden, S, B = 9, 5, (16, 16), 8, 16
    M = S * B
    kw = dict(hidden=hidden, epochs=2, lr=1e-3, max_grad_norm=0.5)
    tree = _tree(O, A, hidden, 2, mu_scale=30.0)
    flat_data = _update_data(tree, O, A, M, 2, logp_noise=0.3)
    obs, pre, old, adv, ret = flat_data
    data = (obs.reshape(O, S, B), pre.reshape(A, S, B), old.reshape(S, B),
            adv.reshape(S, B), ret.reshape(S, B))
    jcfg = jppo.PPOConfig(**kw, learner_dtype=jnp.bfloat16,
                          fused_update=fused_update,
                          fused_update_interpret=True)
    jloss = jppo._make_cont_loss(jcfg)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     optax.adam(jcfg.lr))
    jtree = jax.tree.map(jnp.asarray, tree)
    want, _, _ = jppo._make_update(jcfg, tx, jloss, dims=(O, A))(
        jtree, tx.init(jtree), tuple(map(jnp.asarray, data)))

    cfg = ppo.PPOConfig(**kw, learner_dtype=BF16, fused_update=fused_update)
    loss = ppo._make_cont_loss(cfg)
    model = params_from_jax(tree, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    ppo._make_update(cfg, loss, dims=(O, A))(
        model, opt, tuple(map(torch.from_numpy, data)))
    got = _vec(p.detach().numpy() for p in model.flat()) - _vec(_leaves(tree))
    ref = _vec(_leaves(jax.tree.map(np.asarray, want))) - _vec(_leaves(tree))
    assert np.linalg.norm(ref) > 0
    assert _cos(got, ref) >= 0.999
    if fused_update:
        return
    jg = jax.grad(lambda p: jloss(p, *map(jnp.asarray, flat_data))[0])(jtree)
    model = params_from_jax(tree, device="cpu")
    g = torch.autograd.grad(loss(model, *map(torch.from_numpy, flat_data))[0],
                            model.flat())
    assert _cos(_vec(x.numpy() for x in g), _vec(_leaves(jg))) >= 0.9999


def _cc(T=8):
    return compile_chain(
        simple_chain(initial_stock=10, stock_capacity=100, supply_capacity=50,
                     processing_capacity=100, ship_capacity=100),
        demand_range=(0, 5), processing_ratio=2, total_time_steps=T,
        stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4)


def test_ppo_improves_bf16_learner():
    """The bf16 update (update phase only) moves the parameters along the
    float32 full-batch update from the same rollout (the rollout forward
    is float32 in both, so the same seed gives the same trajectory), and
    minibatched epochs run and move the parameters."""
    cc = _cc()
    B = 32
    kw = dict(rollout_steps=8, epochs=2, hidden=(32, 32))
    init32, step32 = ppo.make_ppo(cc, B, ppo.PPOConfig(**kw), device="cpu")
    init16, step16 = ppo.make_ppo(cc, B, ppo.PPOConfig(**kw,
                                                       learner_dtype=BF16),
                                  device="cpu")

    def delta(init, step):
        s0 = init(0)
        p0 = _vec(p.detach().numpy() for p in s0.params.flat())
        s1, m = step(s0)
        assert np.isfinite(float(m["loss"]))
        return _vec(p.detach().numpy() for p in s1.params.flat()) - p0

    d32, d16 = delta(init32, step32), delta(init16, step16)
    assert np.linalg.norm(d32) > 0 and np.linalg.norm(d16) > 0
    cos = _cos(d32, d16)
    assert cos > 0.9, f"bf16 update diverges from f32: cosine {cos:.3f}"

    initmb, stepmb = ppo.make_ppo(cc, B, ppo.PPOConfig(**kw, minibatches=4),
                                  device="cpu")
    assert np.linalg.norm(delta(initmb, stepmb)) > 0


@pytest.mark.parametrize("O,A,hidden,instance", [
    (27, 14, (128, 128), (128, 2, 32, 16)),     # ntom, the trainer's widths
    (6, 3, (32, 32), (64, 2, 32, 16)),          # a small width pads to 64
    (27, 14, (37,), (64, 1, 32, 16)),
    (13, 5, (33, 17, 9), (64, 3, 32, 16)),
    (27, 14, (64, 32, 16, 8), (64, 4, 32, 16)),
    (27, 14, (65,), (128, 1, 32, 16)),          # one unit past 64
    # the multi-product chains: 64 obs rows, 32 head rows
    (53, 28, (64, 64), (64, 2, 64, 32)),
    (53, 28, (128,), (128, 1, 64, 32)),
    (33, 3, (48,), (64, 1, 64, 32)),            # obs alone past 32
    (6, 17, (16, 16), (64, 2, 64, 32)),         # actions alone past 16
])
def test_bf16_update_kernel_plan(O, A, hidden, instance):
    """The bf16 kernel's instance: hidden layers padded to H = 64 or 128,
    the obs to 32 or 64 rows, the heads to 16 or 32, one of the instances
    the wrapper knows (their shared memory and registers are held on the
    card: ``test_bf16_instances_fit_the_card``)."""
    plan = ppo_update_bf16_plan(MlpLayout(O, A, hidden))
    assert (plan["H"], plan["layers"], plan["KP"], plan["HA"]) == instance
    assert instance[1] in _BF16_INSTANCES[instance[0], instance[2],
                                          instance[3]]


@pytest.mark.parametrize("O,A,hidden,kernel", [
    (27, 14, (256,), "mma"),                # wider than 128
    (53, 28, (64, 64, 64), "wgmma"),        # multiproduct: three layers
    (53, 28, (32, 32, 32), "wgmma"),
    (53, 28, (64, 128), "mma"),             # multiproduct: a layer past 64
    (53, 28, (128, 64), "mma"),
    (79, 60, (64,), "mma"),                 # obs past 64 rows, actions past 32
    (79, 60, (32, 32), "mma"),
])
def test_bf16_update_kernel_plan_takes_the_nets_of_the_mma_kernel(
        O, A, hidden, kernel):
    """Every net the bf16 mode's first (mma.sync) kernel took runs: on the
    wgmma kernel where an instance holds it (three hidden layers at the
    multi-product widths: ``<64,3,64,32>``, whose dH lies after each dZ
    half so that the loss scratch fits), else on the mma.sync kernel, whose
    shared memory the plan gives; chosen by the net's shape alone."""
    plan = ppo_update_bf16_plan(MlpLayout(O, A, hidden))
    assert plan["kernel"] == kernel
    if kernel == "wgmma":
        assert (plan["H"], plan["layers"], plan["KP"], plan["HA"]) == (
            64, 3, 64, 32)
    else:
        assert 0 < plan["smem"] <= SMEM_MAX - 4 * (LAYOUT_INTS + 128)


@pytest.mark.parametrize("O,A,hidden", [
    (27, 14, (128, 128, 128)),      # three layers wider than 64
    (53, 28, (128, 128)),           # multiproduct: two layers past 64
    (53, 28, (256,)),               # multiproduct: wider than 128
    (79, 60, (128, 128)),           # obs past 64 rows, two layers past 64
])
def test_bf16_update_kernel_plan_refuses_what_does_not_fit(O, A, hidden):
    with pytest.raises(NotImplementedError, match="bf16 update kernel takes"):
        ppo_update_bf16_plan(MlpLayout(O, A, hidden))
