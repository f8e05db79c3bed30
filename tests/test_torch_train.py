"""Port parity, training: allocnet_tpu_torch.train.losses and train_step
against allocnet_tpu.train (CPU, f64): the losses and their gradients, the
cosine warm-restart schedule, and two Adam steps through the
differentiable QP from the same weights (carried over with
models/weights.from_jax_params), for the ConvLSTM, the ConvMLP and the
time-factor mode.  Sizes follow tests/test_train.py: hidden 16-32, res=10,
a 2 x 75 solver, B=3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import LossConfig as JLossConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.config import TrainConfig as JTrainConfig
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTM
from allocnet_tpu.models.networks import ConvMLPAllocNet as JConvMLP
from allocnet_tpu.train import losses as jlosses
from allocnet_tpu.train import train_step as jts
from allocnet_tpu_torch.config import (LossConfig, QPConfig, SolverConfig,
                                       TrainConfig)
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet, ConvMLPAllocNet
from allocnet_tpu_torch.train import losses, train_step
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

BUDGET = dict(n_chunks=2, iters_per_chunk=75)
QCFG, SCFG = QPConfig(res=10), SolverConfig(**BUDGET)
JQCFG, JSCFG = JQPConfig(res=10), JSolverConfig(**BUDGET)
# f64 on both sides, the same formulas: losses and their gradients to
# rounding
LOSS_RTOL = 1e-12


def _close(a, b, rtol, atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(
        a, b, rtol=0, atol=atol + rtol * max(1.0, float(np.abs(b).max())))


def test_stop_token_targets():
    gt = losses.stop_token_targets(torch.tensor([1, 3, 5]), 5).numpy()
    np.testing.assert_array_equal(gt, [[1, 1, 1, 1, 1], [0, 0, 1, 1, 1],
                                       [0, 0, 0, 0, 1]])


@pytest.mark.parametrize("head", ["lstm", "mlp"])
@pytest.mark.parametrize("with_ref", [True, False])
def test_losses_and_gradients_match_jax(head, with_ref):
    rng = np.random.default_rng(3)
    B, S = 8, 5
    times = rng.uniform(0.02, 3.0, size=(B, S))
    tokens = rng.uniform(0.0, 1.0, size=(B, S))
    tokens[:, 3:] = 1.0                  # masked steps after a stop
    tokens[0, 0] = 0.42                  # at the threshold
    seg = rng.integers(1, S + 1, size=B)
    solved = rng.uniform(size=B) < 0.6
    obj = rng.uniform(0.1, 50.0, size=B)
    obj[~solved] = np.nan                # a diverged solve's objective
    state = rng.normal(size=(B, 2, 3, 3))
    ref = rng.uniform(0.2, 3.0, size=(B, S)) if with_ref else None
    lcfg = LossConfig()
    use_tok = head == "lstm"

    tt = torch.tensor(times, requires_grad=True)
    tk = torch.tensor(tokens, requires_grad=True)
    to = torch.tensor(obj, requires_grad=True)
    b = losses.compute_losses(
        lcfg, tt, tk if use_tok else None, torch.tensor(seg),
        torch.tensor(solved), to, torch.tensor(state),
        None if ref is None else torch.tensor(ref), 0.42)
    b.total.backward()

    def jtotal(t, k, o):
        jb = jlosses.compute_losses(
            JLossConfig(), t, k if use_tok else None, jnp.asarray(seg),
            jnp.asarray(solved), o, jnp.asarray(state),
            None if ref is None else jnp.asarray(ref), 0.42)
        return jb.total, jb

    (_, jb), jg = jax.value_and_grad(jtotal, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(times), jnp.asarray(tokens), jnp.asarray(obj))
    for name in losses.LossBundle._fields:
        v = getattr(b, name).detach().numpy()
        assert np.isfinite(v), name
        _close(v, getattr(jb, name), LOSS_RTOL)
    _close(tt.grad.numpy(), jg[0], LOSS_RTOL)
    if use_tok:
        _close(tk.grad.numpy(), jg[1], LOSS_RTOL)
    assert torch.isfinite(to.grad).all()
    _close(to.grad.numpy(), jg[2], LOSS_RTOL)


def test_schedule_matches_optax():
    tcfg = TrainConfig()
    sched = train_step.cosine_warm_restarts(tcfg.learning_rate, tcfg.t0,
                                            tcfg.t_mult, tcfg.eta_min)
    jsched = jts.cosine_warm_restarts(tcfg.learning_rate, tcfg.t0,
                                      tcfg.t_mult, tcfg.eta_min)
    steps = np.arange(0, 3001)
    got = np.array([sched(int(k)) for k in steps])
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
    # optax runs the same cosine in f64 here (x64 on): rounding only
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] == tcfg.learning_rate and got[500] == tcfg.learning_rate
    assert abs(got[499] - tcfg.eta_min) < 1e-7          # end of period one
    # the optimizer's learning rate at update k is sched(k)
    net = torch.nn.Linear(2, 1)
    opt, lr_sched = train_step.make_optimizer(net, tcfg)
    for k in range(600):
        if k in (0, 1, 250, 499, 500, 599):
            assert opt.param_groups[0]["lr"] == pytest.approx(got[k],
                                                              rel=1e-12)
        opt.step()
        lr_sched.step()


def _f32_exact(tree):
    """JAX params rounded to f32 values (held as f64): what
    from_jax_params carries over exactly."""
    return jax.tree.map(lambda a: jnp.asarray(np.float32(np.asarray(a)),
                                              jnp.float64), tree)


def _sd_of(jparams):
    return weights.from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("case", ["lstm", "mlp", "lstm_time_factor"])
def test_two_adam_steps_match_jax(case):
    """Two training steps (net -> QP -> loss -> Adam) from the same
    weights: losses, success and the weights after each step agree with
    JAX.  f64 on both sides; the gradients agree to ~1e-12 and Adam's
    normalization keeps the updates within rtol 1e-6 of each other."""
    B = 3
    sc = scenarios.random_scenarios(QCFG, B, seed=41, min_seg=1)
    tcfg, jtcfg = TrainConfig(), JTrainConfig()
    lcfg, jlcfg = LossConfig(), JLossConfig()
    if case == "mlp":
        jnet = JConvMLP(seg=5, seq_len=5, hidden_size=32)
        net = ConvMLPAllocNet(seg=5, seq_len=5, hidden_size=32)
    else:
        jnet = JConvLSTM(seq_len=5, hidden_size=16, token_thresh=0.42)
        net = ConvLSTMAllocNet(5, 16, 0.42)
    tlb = None
    if case == "lstm_time_factor":
        tlb = scenarios.corridor_time_lower_bounds(
            sc.hpolys, sc.state, sc.seg, QCFG.max_vel, QCFG.max_acc)
    batch = (sc.state, sc.hpolys, sc.seg, sc.times)

    jstate = jts.init_state(jnet, jtcfg, jnp.asarray(sc.state),
                            jnp.asarray(sc.hpolys))
    params = _f32_exact(jstate.params)
    if case != "mlp":
        # a time head that starts at ~2 s per segment (a factor of ~2.5
        # over the lower bound), so that the QPs solve and the implicit
        # gradient carries the loss (the MLP head starts at ~1.06 s)
        bias = 1.5 if tlb is not None else 2.0
        params = {"params": dict(params["params"],
                                 tf_b=jnp.full((1,), bias, jnp.float64))}
    jstate = jts.TrainState(params, jts.make_optimizer(jtcfg).init(params),
                            jstate.step)
    net.load_state_dict(_sd_of(params))
    net = net.double()
    opt, lr_sched = train_step.make_optimizer(net, tcfg)

    jstep = jax.jit(lambda s, st, hp, sg, rt, lb: jts.train_step(
        s, jnet, jtcfg, JQCFG, JSCFG, jlcfg, st, hp, sg, rt, tlb=lb))
    for _ in range(2):
        bundle = train_step.train_step(
            net, opt, lr_sched, QCFG, SCFG, lcfg,
            *(torch.tensor(a) for a in batch), token_thresh=0.42,
            tlb=None if tlb is None else torch.tensor(tlb))
        jstate, jb = jstep(jstate, *(jnp.asarray(a) for a in batch),
                           None if tlb is None else jnp.asarray(tlb))
        assert np.isfinite(float(bundle.total.detach()))
        for name in ("total", "obj1", "objt", "objc", "stop",
                     "success_rate"):
            _close(float(getattr(bundle, name)), float(getattr(jb, name)),
                   1e-9)
        want = _sd_of(jstate.params)
        for k, v in net.state_dict().items():
            _close(v.numpy(), want[k].double().numpy(), 1e-6)
    assert 0.0 < float(bundle.success_rate)


def test_unsolved_branch_has_finite_nonzero_gradient():
    """The wt branch: with infeasibly small predicted times the time head
    still gets a finite, nonzero gradient (supervised fallback)."""
    net = ConvLSTMAllocNet(5, 16, 0.42).double()
    with torch.no_grad():
        net.tfs_output_layer.bias.fill_(-5.0)        # times ~ -5 -> 0.05
    sc = scenarios.random_scenarios(QCFG, 3, seed=47, min_seg=2)
    total, bundle = train_step.loss_fn(
        net, QCFG, SCFG, LossConfig(), *(torch.tensor(a) for a in (
            sc.state, sc.hpolys, sc.seg, sc.times)), 0.42)
    assert float(bundle.success_rate) == 0.0
    total.backward()
    g = net.tfs_output_layer.bias.grad
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
