"""Parity of the port's layer surface with the JAX package: ``BoxQPLayer``
and the ``nn.Module``s of ``lqp_py_tpu_torch.nn`` (against the flax
modules, weights carried over), the stateful ``BoxQP``, and the
Experiment-2 trainer (``models/train.py``) step for step in float64.

Data and weights are made once (numpy, the JAX generators, JAX's
``init_params`` and flax ``init``) and handed to both packages as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import lqp_py_tpu as J
from lqp_py_tpu.models import train as jtrain
from lqp_py_tpu.nn import BoxQPModule as JBoxQPModule
from lqp_py_tpu.nn import LinearBoxQP as JLinearBoxQP
from lqp_py_tpu.utils.generators import create_qp_data
import lqp_py_tpu_torch as T
from lqp_py_tpu_torch import nn as tnn
from lqp_py_tpu_torch.models import train as ttrain
from lqp_py_tpu_torch.utils.convert import (linear_box_qp_from_flax,
                                            linear_qp_from_numpy,
                                            problem_from_numpy)

TIGHT = dict(eps_abs=1e-10, eps_rel=1e-10, max_iters=50000)


def _np_data(n, B, seed):
    return [np.asarray(a, np.float64) for a in
            create_qp_data(n, B, seed=seed, dtype=jnp.float64)]


def test_box_qp_layer_and_module_match_jax_module():
    d = _np_data(12, 3, seed=2)
    cfg = dict(eps_abs=1e-7, eps_rel=1e-7)
    theirs = JBoxQPModule(config=J.BoxQPConfig(**cfg)).apply(
        {}, *map(jnp.asarray, d))
    data = problem_from_numpy(*d, device="cpu")
    for layer in (T.BoxQPLayer(T.BoxQPConfig(**cfg)),
                  tnn.BoxQPModule(T.BoxQPConfig(**cfg))):
        assert isinstance(layer, nn.Module)
        assert list(layer.parameters()) == []
        np.testing.assert_allclose(layer(*data).numpy(), np.asarray(theirs),
                                   rtol=1e-9, atol=1e-10)


def test_linear_box_qp_carries_flax_weights_and_grads():
    """The flax LinearBoxQP's parameters, carried over, give the same
    output and the same parameter gradients of sum(w * x)."""
    n_x, B, n_f = 10, 3, 5
    d = _np_data(n_x, B, seed=3)
    Q, _p, A, b, lb, ub = d
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((B, n_f))
    w = rng.standard_normal((B, n_x))
    cfg = TIGHT
    jmod = JLinearBoxQP(n_x=n_x, config=J.BoxQPConfig(**cfg))
    jd = [jnp.asarray(a) for a in (feats, Q, A, b, lb, ub)]
    params = jmod.init(jax.random.PRNGKey(1), *jd)["params"]

    def loss(params):
        return jnp.sum(jnp.asarray(w) * jmod.apply({"params": params}, *jd))

    jl, jg = jax.value_and_grad(loss)(params)
    # flax keeps the Dense parameters in float32 and computes in float64;
    # the port computes with them cast to float64 (exact), and the JAX
    # gradients come back rounded to float32: compared at rtol 1e-6.
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tmod = linear_box_qp_from_flax(np_params, config=T.BoxQPConfig(**cfg),
                                   device="cpu", dtype=torch.float64)
    assert isinstance(tmod, nn.Module)
    assert tmod.cost_head.weight.shape == (n_x, n_f)
    assert tmod.cost_head.weight.dtype == torch.float64
    x = tmod(*(torch.from_numpy(a) for a in (feats, Q, A, b, lb, ub)))
    tl = (torch.from_numpy(w) * x).sum()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-10)
    np.testing.assert_allclose(tmod.cost_head.weight.grad.numpy().T,
                               np.asarray(jg["cost_head"]["kernel"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tmod.cost_head.bias.grad.numpy(),
                               np.asarray(jg["cost_head"]["bias"]),
                               rtol=1e-6, atol=1e-7)


def test_stateful_box_qp_matches_jax():
    """A p-only update keeps the preparation, any other update drops it,
    and warm starts cut the iterations; every solve matches the JAX
    wrapper's."""
    d = _np_data(20, 3, seed=12)
    cfg = dict(eps_abs=1e-8, eps_rel=1e-8)
    jq = J.BoxQP(*map(jnp.asarray, d), control=J.BoxQPConfig(**cfg),
                 warm_start=True)
    tq = T.BoxQP(*problem_from_numpy(*d, device="cpu"),
                 control=T.BoxQPConfig(**cfg), warm_start=True)

    def both(step):
        xj, xt = jq.solve(), tq.solve()
        assert tq.sol.iterations == int(jq.sol.iterations), step
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-8, err_msg=step)
        return tq.sol.iterations

    it0 = both("first solve")
    prep = tq._prep
    assert prep is not None
    p2 = d[1] * 1.001
    jq.update(p=jnp.asarray(p2))
    tq.update(p=torch.from_numpy(p2))
    assert tq._prep is prep                    # p only: kept
    assert both("p update, warm") < it0
    assert tq._prep is prep
    lb2 = d[4] - 0.1
    jq.update(lb=jnp.asarray(lb2))
    tq.update(lb=torch.from_numpy(lb2))
    assert tq._prep is None                    # bounds changed: dropped
    both("lb update")
    assert tq._prep is not None and tq._prep is not prep
    tq.update(control=T.BoxQPConfig(eps_abs=1e-6, eps_rel=1e-6))
    assert tq._prep is None


def _trainer_data(n_x=8, n_f=3, B=8, mini=4, steps=3, seed=0):
    d = _np_data(n_x, B, seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, n_f))
    beta = rng.standard_normal((n_f, n_x))
    p_true = feats @ beta
    sel = np.stack([rng.choice(B, mini, replace=False)
                    for _ in range(steps)])
    params = jtrain.init_params(jax.random.PRNGKey(seed), n_f, n_x,
                                jnp.float64)
    return d, feats, p_true, sel, params


def test_trainer_tracks_jax_step_for_step():
    """Weights from the JAX init_params, carried over; three SGD steps on
    the same minibatches in float64: the parameters after every step and
    the losses agree to 1e-9."""
    d, feats, p_true, sel, jparams = _trainer_data()
    Q, _p, A, b, lb, ub = d
    lr = 0.05                   # large enough that the weights move
    cfg = dict(TIGHT)
    jstep = jtrain.make_train_step(J.BoxQPConfig(**cfg), lr=lr)
    tstep = ttrain.make_train_step(T.BoxQPConfig(**cfg), lr=lr)
    tparams = linear_qp_from_numpy(jparams._replace(
        W=np.asarray(jparams.W), bias=np.asarray(jparams.bias)),
        device="cpu")
    assert isinstance(tparams, ttrain.LinearQP)
    W0 = tparams.W.detach().clone()
    full = (feats, Q, p_true, A, b, lb, ub)
    for idx in sel:
        mb = [a[idx] for a in full]
        jparams, jl = jstep(jparams, *map(jnp.asarray, mb))
        tparams, tl = tstep(tparams, *map(torch.from_numpy, mb))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-9)
        np.testing.assert_allclose(tparams.W.detach().numpy(),
                                   np.asarray(jparams.W), rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(tparams.bias.detach().numpy(),
                                   np.asarray(jparams.bias), rtol=1e-9,
                                   atol=1e-10)
    assert (tparams.W.detach() - W0).abs().max() > 1e-4


def test_train_scan_equals_the_step_loop():
    d, feats, p_true, sel, jparams = _trainer_data(seed=1)
    Q, _p, A, b, lb, ub = d
    cfg = T.BoxQPConfig(**TIGHT)
    full = [torch.from_numpy(a) for a in (feats, Q, p_true, A, b, lb, ub)]

    def fresh():
        return linear_qp_from_numpy(jparams._replace(
            W=np.asarray(jparams.W), bias=np.asarray(jparams.bias)),
            device="cpu")

    run = ttrain.make_train_scan(cfg, lr=0.05)
    p_scan, losses = run(fresh(), torch.from_numpy(sel), *full)
    step = ttrain.make_train_step(cfg, lr=0.05)
    p_loop, loop_losses = fresh(), []
    for idx in sel:
        p_loop, loss = step(p_loop, *(a[idx] for a in full))
        loop_losses.append(loss)
    assert losses.shape == (len(sel),)
    torch.testing.assert_close(losses, torch.stack(loop_losses), rtol=0,
                               atol=0)
    torch.testing.assert_close(p_scan.W, p_loop.W, rtol=0, atol=0)


def test_init_params_and_predict_p():
    g = torch.Generator().manual_seed(0)
    params = ttrain.init_params(4, 6, generator=g, dtype=torch.float64,
                                device="cpu")
    assert params.W.shape == (4, 6) and params.bias.shape == (6,)
    assert torch.all(params.bias == 0)
    feats = torch.randn((3, 4), dtype=torch.float64, generator=g)
    torch.testing.assert_close(ttrain.predict_p(params, feats),
                               feats @ params.W)
    jp = jtrain.LinearQPParams(W=jnp.asarray(params.W.detach().numpy()),
                               bias=jnp.asarray(params.bias.detach().numpy()))
    np.testing.assert_allclose(
        ttrain.predict_p(params, feats).detach().numpy(),
        np.asarray(jtrain.predict_p(jp, jnp.asarray(feats.numpy()))),
        rtol=1e-12)
    Q = torch.eye(6, dtype=torch.float64).expand(3, 6, 6)
    z = torch.ones((3, 6), dtype=torch.float64)
    assert ttrain.qp_objective(Q, torch.zeros_like(z), z).item() == 3.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_linear_box_qp_module_defaults(dtype):
    mod = tnn.LinearBoxQP(5, 7, device="cpu", dtype=dtype)
    assert mod.cost_head.weight.shape == (7, 5)
    assert mod.cost_head.weight.dtype == dtype
    assert mod.config == T.BoxQPConfig()
