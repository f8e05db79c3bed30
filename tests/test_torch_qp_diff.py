"""Port parity, differentiable solve: allocnet_tpu_torch.ops.qp_diff (a
torch.autograd.Function) against allocnet_tpu.ops.qp_diff (a custom_vjp),
and against central finite differences of the port's own solver, in f64 on
the CPU, where both sides run the plain ADMM scan and the same polish.
Sizes follow tests/test_qp_diff.py: B <= 3, res=10, a 2 x 75 solver."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.ops import qp_diff as jqp_diff
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, qp, qp_diff
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

BUDGET = dict(n_chunks=2, iters_per_chunk=75, polish_rounds=2)
CFG, SCFG = QPConfig(res=10), SolverConfig(**BUDGET)
JCFG, JSCFG = JQPConfig(res=10), JSolverConfig(**BUDGET)
# JAX and the port run the same f64 iterations and the same KKT backward:
# gradients agree to ~1e-13 of the largest; rtol 1e-6 as stated for the
# port (an LU with other pivots may differ in the last digits)
GRAD_RTOL = 1e-6
# central differences with eps 1e-5 on a solver converged to ~1e-10
FD_RTOL, FD_ATOL, FD_EPS = 5e-3, 1e-5, 1e-5


def _inputs(B, seed, min_seg=2):
    sc = scenarios.random_scenarios(CFG, B, seed=seed, min_seg=min_seg)
    w = np.random.default_rng(seed + 1).normal(size=(B, CFG.max_seg, 3,
                                                     CFG.D))
    return sc, w


def _port_grads(sc, w, which=(0, 1, 2)):
    ins = [torch.tensor(a, requires_grad=i in which)
           for i, a in enumerate((sc.state, sc.hpolys, sc.times))]
    coeffs, sol = qp_diff.solve(CFG, SCFG, *ins, torch.tensor(sc.seg))
    (coeffs * torch.tensor(w)).sum().backward()
    return coeffs.detach().numpy(), sol, [t.grad for t in ins]


def _per_sample_port(state, hpolys, times, seg, w):
    with torch.no_grad():
        coeffs, _ = qp_diff.solve(CFG, SCFG, torch.tensor(state),
                                  torch.tensor(hpolys), torch.tensor(times),
                                  torch.tensor(seg))
    return (coeffs.numpy() * w).sum((1, 2, 3))


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(b).max())))


def test_gradients_match_jax():
    sc, w = _inputs(3, 31)
    coeffs, sol, grads = _port_grads(sc, w)

    def jloss(st, hp, tm):
        c, _ = jqp_diff.solve(JCFG, JSCFG, st, hp, tm, jnp.asarray(sc.seg))
        return jnp.sum(jnp.asarray(w) * c), c

    (_, jc), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(
        jnp.asarray(sc.state), jnp.asarray(sc.hpolys), jnp.asarray(sc.times))
    assert bool(sol.solved.all())
    _close(coeffs, jc, 1e-9)
    for g, jgrad in zip(grads, jg):
        assert g is not None and torch.isfinite(g).all()
        _close(g.numpy(), jgrad, GRAD_RTOL)
    # the forward value is the plain solve's
    data = qp.build_qp(CFG, sc.state, sc.hpolys, sc.times, sc.seg,
                       device="cpu")
    np.testing.assert_array_equal(coeffs, admm.solve_qp(data, SCFG).coeffs)


def test_gradient_matches_fd_times():
    sc, w = _inputs(3, 31)
    _, _, grads = _port_grads(sc, w, which=(2,))
    probes = [(b, i) for b in range(3) for i in range(int(sc.seg[b]))]
    st, hp, tm, sg, ws = [], [], [], [], []
    for b, i in probes:
        for sign in (FD_EPS, -FD_EPS):
            t = np.array(sc.times[b])
            t[i] += sign
            st.append(sc.state[b]); hp.append(sc.hpolys[b]); tm.append(t)
            sg.append(sc.seg[b]); ws.append(w[b])
    vals = _per_sample_port(*map(np.stack, (st, hp, tm, sg, ws)))
    fd = (vals[0::2] - vals[1::2]) / (2 * FD_EPS)
    g = grads[2].numpy()
    for k, (b, i) in enumerate(probes):
        np.testing.assert_allclose(g[b, i], fd[k], rtol=FD_RTOL, atol=FD_ATOL)


def test_gradient_matches_fd_state():
    sc, w = _inputs(2, 33)
    _, _, grads = _port_grads(sc, w, which=(0,))
    rng = np.random.default_rng(7)
    probes = [tuple(int(rng.integers(0, n)) for n in (2, 2, 3, 3))
              for _ in range(8)]
    st, hp, tm, sg, ws = [], [], [], [], []
    for b, i, j, r in probes:
        for sign in (FD_EPS, -FD_EPS):
            s = np.array(sc.state[b])
            s[i, j, r] += sign
            st.append(s); hp.append(sc.hpolys[b]); tm.append(sc.times[b])
            sg.append(sc.seg[b]); ws.append(w[b])
    vals = _per_sample_port(*map(np.stack, (st, hp, tm, sg, ws)))
    fd = (vals[0::2] - vals[1::2]) / (2 * FD_EPS)
    g = grads[0].numpy()
    for k, (b, i, j, r) in enumerate(probes):
        np.testing.assert_allclose(g[b, i, j, r], fd[k], rtol=FD_RTOL,
                                   atol=FD_ATOL)


def test_objective_gradient_matches_jax_and_fd():
    """d(obj)/d(times) through the solution: the objc loss path."""
    sc, _ = _inputs(2, 35)
    tm = torch.tensor(sc.times, requires_grad=True)
    args = (torch.tensor(sc.state), torch.tensor(sc.hpolys))
    seg = torch.tensor(sc.seg)
    coeffs, _ = qp_diff.solve(CFG, SCFG, *args, tm, seg)
    obj = qp_diff.objective(CFG, *args, tm, seg, coeffs)
    obj.sum().backward()

    def jobj(t):
        st, hp, sg = (jnp.asarray(a) for a in (sc.state, sc.hpolys, sc.seg))
        c, _ = jqp_diff.solve(JCFG, JSCFG, st, hp, t, sg)
        return jnp.sum(jqp_diff.objective(JCFG, st, hp, t, sg, c))

    jg = jax.jit(jax.grad(jobj))(jnp.asarray(sc.times))
    _close(tm.grad.numpy(), jg, GRAD_RTOL)

    probes = [(b, i) for b in range(2) for i in range(int(sc.seg[b]))]
    vals = []
    for b, i in probes:
        for sign in (FD_EPS, -FD_EPS):
            t = np.array(sc.times)
            t[b, i] += sign
            with torch.no_grad():
                c, _ = qp_diff.solve(CFG, SCFG, *args, torch.tensor(t), seg)
                vals.append(float(qp_diff.objective(
                    CFG, *args, torch.tensor(t), seg, c)[b]))
    fd = (np.array(vals[0::2]) - np.array(vals[1::2])) / (2 * FD_EPS)
    for k, (b, i) in enumerate(probes):
        np.testing.assert_allclose(tm.grad[b, i].item(), fd[k], rtol=1e-2,
                                   atol=FD_ATOL)
    assert float(tm.grad.mean()) < 0     # longer times, smoother plan


def test_unsolved_scenarios_zero_grad():
    sc, _ = _inputs(2, 37)
    times = torch.full(sc.times.shape, 0.05, dtype=torch.float64,
                       requires_grad=True)                    # infeasible
    coeffs, sol = qp_diff.solve(CFG, SCFG, torch.tensor(sc.state),
                                torch.tensor(sc.hpolys), times,
                                torch.tensor(sc.seg))
    assert not bool(sol.solved.any())
    coeffs.sum().backward()
    assert torch.equal(times.grad, torch.zeros_like(times))


def test_gradcheck_f64():
    """torch.autograd.gradcheck of coeffs(times) at B=1, res=4: the
    backward's vector-Jacobian products against its own finite
    differences (eps 1e-6, gradcheck's default atol 1e-5, rtol 1e-3)."""
    cfg = QPConfig(res=4)
    sc = scenarios.random_scenarios(cfg, 1, seed=39, min_seg=3)
    args = (torch.tensor(sc.state), torch.tensor(sc.hpolys))
    seg = torch.tensor(sc.seg)

    def f(t):
        coeffs, sol = qp_diff.solve(cfg, SCFG, *args, t, seg)
        assert bool(sol.solved.all())
        return coeffs

    times = torch.tensor(sc.times, requires_grad=True)
    assert torch.autograd.gradcheck(f, (times,), eps=1e-6, atol=1e-5,
                                    rtol=1e-3)


def test_f32_forward_and_backward_run_on_the_chunk_path():
    """f32 with use_pallas takes the chunk kernel's plain version on the
    CPU (as the card takes the kernel); its gradients stay within 1e-2 of
    the f64 ones (one f32 solve, the f32 LU, cond(KKT) ~ 1e4)."""
    sc, w = _inputs(2, 41)
    _, sol64, g64 = _port_grads(sc, w, which=(2,))
    tm = torch.tensor(sc.times, dtype=torch.float32, requires_grad=True)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    coeffs, sol = qp_diff.solve(CFG, SolverConfig(**BUDGET),
                                f32(sc.state), f32(sc.hpolys), tm,
                                torch.tensor(sc.seg))
    (coeffs * f32(w)).sum().backward()
    assert coeffs.dtype == torch.float32 and tm.grad.dtype == torch.float32
    assert torch.equal(sol.solved, sol64.solved)
    _close(tm.grad.double().numpy(), g64[2].numpy(), 1e-2)
