"""Port parity at the ten-segment operating point (`config.SEQ10`: the
reference's ModelMaxSeg = 10 with the shipped seq10_rest2rest net), on
the CPU against the JAX package: the fused chunk against the TPU kernel
(admm_tiled.run_chunk in interpret mode) and both against the same chunk
evaluated in f64; the kernel's skip rule; build_qp and solve_qp (the JAX
side runs its XLA-scan core); plan_batch with the seq10 net, with and
without refinement; plan_many on a maze whose corridors need more than 5
segments; one training step.

Run as a script, ``python -m tests.test_torch_seq10``, it prints the
chunk accuracy table of PERF.md: each side's error against the f64 chunk
at 5 and 10 segments, with Kx rrow summed in f32 and in f64, and with Kx^T
(both kernels' orientation) and Kx applied."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import CorridorConfig as JCorridorConfig
from allocnet_tpu.config import LossConfig as JLossConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.models import import_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTMAllocNet
from allocnet_tpu.ops import admm as jadmm
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu.planner import pipeline as jpipeline
from allocnet_tpu.planner import planner as jplanner
from allocnet_tpu.train import train_step as jts
from allocnet_tpu_torch import config
from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       LossConfig, QPConfig, SolverConfig)
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, qp
from allocnet_tpu_torch.planner import pipeline, planner
from allocnet_tpu_torch.train import datagen, train_step
from allocnet_tpu_torch.utils import scenarios
from tests.oracle import qp_oracle
from tests.test_seq10_e2e import _maze_map
from tests.test_torch_admm_chunk import (ALPHA, SIGMA, _chunk_case,
                                         _run_both, _skipped_parts_unchanged)
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data/params/seq10_rest2rest.msgpack")
S = 10
KEYS = ("x", "z", "yh", "yeh")
# the S = 5 parity test's chunk cases (tests/test_torch_admm_chunk.py);
# the test runs the res-10 ones (each new shape costs the JAX side ~12 s
# of op compiles), the script all three
CHUNK_CASES = [(10, 8, 5, 1), (10, 8, 5, 20), (20, 4, 11, 10)]
# Chunk against the same chunk in f64 (same inputs, same Kx^T), as a
# fraction of each array's largest entry.  Measured at 10 segments on the
# three cases: the port (f64 sum of Kx rrow) <= 2.1e-5, K1 (f32 sum) up to
# 2.3e-3.  The port is held to the S = 5 test's 1e-4, K1 to 5e-3.
PORT_TOL = 1e-4
K1_TOL = 5e-3
# tests/test_seq10_e2e.py's operating point: res 10, generous box limits
# (the seq10 net is out of distribution on synthetic corridors), 2 x 150
# iterations
QKW = dict(res=10, max_seg=S, max_vel=8.0, max_acc=12.0)
BUDGET = dict(n_chunks=2, iters_per_chunk=150)
QCFG, SCFG = QPConfig(**QKW), SolverConfig(**BUDGET)
JQCFG, JSCFG = JQPConfig(**QKW), JSolverConfig(**BUDGET)
# seeded scenarios on which the seq10 net's times solve: of
# random_scenarios(QCFG, 8, seed=41, min_seg=1) (segments 7 8 10 2 7 7 6
# 1), scenario 5 (7 segments) and 3 (2), then 0 (7, unsolved)
SEED, PICK = 41, [5, 3, 0]
# The JAX programs, jitted: one compile each instead of op-by-op dispatch
# (the same functions; plan_many's plan_batch takes the same program)
_jplan_batch = jax.jit(jpipeline.plan_batch, static_argnums=(0, 2, 3),
                       static_argnames=("refine_steps",))


def _rel(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = torch.as_tensor(np.asarray(a)).double(), b.double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def chunk_errors(res, B, seed, n_iters, max_seg, kx_t=False):
    """Each side's error against the chunk evaluated in f64 on the same f32
    inputs (same packing, same Kx orientation): {'port', 'port_f32_sum',
    'K1'} -> {array: error over the f64 chunk's largest entry}.  `kx_t`
    gives every side Kx^T in place of Kx."""
    got, want, args = _run_both(res, B, seed, n_iters, max_seg, kx_t)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    exact = admm_chunk.admm_chunk_reference(*f64, n_iters, SIGMA, ALPHA)
    f32_sum = admm_chunk.admm_chunk_reference(*args, n_iters, SIGMA, ALPHA,
                                              sum_dtype=torch.float32)
    sides = dict(port=got, port_f32_sum=dict(zip(KEYS, f32_sum)), K1=want)
    for side in sides.values():
        for k in KEYS:
            assert np.isfinite(np.asarray(side[k])).all(), k
    return {name: {k: _rel(side[k], e) for k, e in zip(KEYS, exact)}
            for name, side in sides.items()}


@pytest.mark.parametrize("res,B,seed,n_iters", CHUNK_CASES[:2])
def test_chunk_at_ten_segments_against_f64_and_tpu_kernel(res, B, seed,
                                                          n_iters):
    """The port's plain chunk is nearer the f64 chunk than the TPU kernel
    is: the gap between the two at 10 segments is K1's f32 sum."""
    errs = chunk_errors(res, B, seed, n_iters, S)
    port, k1 = max(errs["port"].values()), max(errs["K1"].values())
    assert port <= PORT_TOL, errs
    assert k1 <= K1_TOL, errs
    assert port < k1, errs


@pytest.mark.parametrize("warm", [False, True])
def test_skip_rule_at_ten_segments(warm):
    """live_parts at 10 segments: a cold start skips each scenario's padded
    segments and faces, a nonzero padded warm start keeps every part of
    its scenarios live, and the dense chunk leaves exactly the skipped
    parts as they were."""
    cfg, scfg, sc, data, args = _chunk_case(10, 8, 3, warm, max_seg=S)
    Ls, face_live = admm_chunk.live_parts(*args)
    noisy = (np.arange(8) % 2 == 0) if warm else np.zeros(8, bool)
    np.testing.assert_array_equal(Ls.numpy()[~noisy], sc.seg[~noisy])
    np.testing.assert_array_equal(Ls.numpy()[noisy], S)
    assert sc.seg.max() > 5
    out = admm_chunk.admm_chunk(*args, 20, scfg.sigma, scfg.alpha)
    for t in out:
        assert torch.isfinite(t).all()
    _skipped_parts_unchanged(cfg, args, out, Ls, face_live)


def test_every_check_batch_at_ten_segments():
    """The kernel's check batches take cfg.max_seg everywhere: every
    segment live on 'every_segment' and 'full_faces' (every face slot in
    use there), 1 on 'one_segment', up to 10 with a padded warm start."""
    cfg, scfg = QPConfig(res=4, max_seg=S), SolverConfig()
    for kind in admm_chunk.CHECK_BATCHES:
        args = admm_chunk.check_batch(kind, cfg, scfg, 6, 11, "cpu")
        assert args[0].shape == (6, cfg.n_var)
        Ls, face_live = admm_chunk.live_parts(*args)
        live = dict(one_segment=1, every_segment=S, full_faces=S)
        if kind in live:
            np.testing.assert_array_equal(Ls.numpy(), live[kind])
        else:
            np.testing.assert_array_equal(Ls.numpy()[::2], S)
        if kind == "full_faces":
            assert bool(face_live.all())


# f64: the same arithmetic up to summation order; f32: sums over <= 240
# terms (tests/test_torch_qp.py's bars)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_build_qp_at_ten_segments_matches_jax(dtype, tol):
    cfg, jcfg = QPConfig(res=10, max_seg=S), JQPConfig(res=10, max_seg=S)
    assert cfg.n_var == 240 and cfg.n_eq == 126
    sc = scenarios.random_scenarios(cfg, 8, seed=5, min_seg=1)
    arrs = [sc.state.astype(dtype), sc.hpolys.astype(dtype),
            sc.times.astype(dtype), sc.seg]
    data = qp.build_qp(cfg, *arrs, device="cpu")

    def jax_side(*a):
        d = jqp.build_qp(jcfg, *a)
        return [getattr(d, k) for k in jqp.QPData._fields[:-1]] + [
            jqp.normal_matrix(d, 1e-6, 300.0, 3.0)]
    want = jax.jit(jax_side)(*(jnp.asarray(a) for a in arrs))
    got = [getattr(data, k) for k in qp.QPData._fields[:-1]] + [
        qp.normal_matrix(data, 1e-6, 300.0, 3.0)]
    for name, g, w in zip(qp.QPData._fields[:-1] + ("M",), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= tol * scale, name


def test_solve_qp_at_ten_segments_matches_jax():
    """f32: the port's chunk loop (the kernel's plain version) against the
    JAX XLA scan: the same solved flags; on the scenarios both solve, the
    port within 1e-3 of the f64 KKT-certified oracle (bench.py's bar) and
    of JAX, except where JAX is the farther from the oracle (measured: the
    JAX f32 scan lands 4.4e-3 from it on scenario 6, a 7-segment
    corridor, with a primal residual of 9.3e-4; the port 4.2e-8).  The
    port's bench gate against the oracle on a full batch is the card's
    (chip_smoke.py, seq10 phase)."""
    sc = scenarios.random_scenarios(QCFG, 8, seed=5, min_seg=1)
    arrs = [sc.state.astype(np.float32), sc.hpolys.astype(np.float32),
            sc.times.astype(np.float32), sc.seg]
    sol = admm.solve_qp(qp.build_qp(QCFG, *arrs, device="cpu"), SCFG)
    jsol = jax.tree.map(np.asarray, jax.jit(
        lambda *a: jadmm.solve_qp(jqp.build_qp(JQCFG, *a), JSCFG))(
            *(jnp.asarray(a) for a in arrs)))
    solved = sol.solved.numpy()
    np.testing.assert_array_equal(solved, jsol.solved)
    both = solved & jsol.solved
    assert both.sum() >= 6 and (sc.seg[both] > 5).any()
    c = sol.coeffs.numpy()
    assert c.shape == (8, S, 3, 8) and np.isfinite(c).all()
    scale = max(1.0, float(np.abs(jsol.coeffs[both]).max()))
    far = both & (np.abs(c - jsol.coeffs).reshape(8, -1).max(1)
                  > 1e-3 * scale)
    for b in np.nonzero(far)[0]:
        L = int(sc.seg[b])
        ora = qp_oracle.solve_scenario(QCFG, *(a[b].astype(np.float64)
                                               for a in arrs[:3]), L)
        assert ora["kkt"] < 1e-7
        port = float(np.abs(c[b, :L] - ora["coeffs"]).max())
        assert port <= 1e-3 * scale, b
        assert port < float(np.abs(jsol.coeffs[b, :L]
                                   - ora["coeffs"]).max()), b


def test_solved_fraction_at_ten_segments_is_the_references():
    """At the S = 10 QP of config.SEQ10 (res 20) and SolverConfig(), 64
    seeded scenarios in f32: the port's CPU solve and the JAX package's
    XLA scan solve fractions within 0.05 of each other and agree on at
    least 0.95 of the flags, and every scenario both leave unsolved has
    more than 5 live segments: the ~0.70 the card solves at S = 10 is the
    reference's own figure (measured: 0.7656 port, 0.7500 JAX, flags
    agree on 0.9844).  Prints each side's polish acceptance per scenario
    (`polished`: the or over the polish rounds of the `better` mask)."""
    qcfg = QPConfig(max_seg=S)
    sc = scenarios.random_scenarios(qcfg, 64, seed=123, min_seg=1)
    arrs = [sc.state.astype(np.float32), sc.hpolys.astype(np.float32),
            sc.times.astype(np.float32), sc.seg]
    sol = admm.solve_qp(qp.build_qp(qcfg, *arrs, device="cpu"),
                        SolverConfig())
    jsol = jax.tree.map(np.asarray, jax.jit(
        lambda *a: jadmm.solve_qp(jqp.build_qp(JQPConfig(max_seg=S), *a),
                                  JSolverConfig()))(
            *(jnp.asarray(a) for a in arrs)))
    solved, jsolved = sol.solved.numpy(), jsol.solved
    for name, pol, s in (("port", sol.polished.numpy(), solved),
                         ("JAX", jsol.polished, jsolved)):
        print(f"{name}: solved {s.mean():.4f}, polish accepted "
              f"{pol.mean():.4f}: " + "".join("1" if p else "0"
                                               for p in pol))
    assert abs(solved.mean() - jsolved.mean()) <= 0.05
    assert (solved == jsolved).mean() >= 0.95
    assert (sc.seg[~solved & ~jsolved] > 5).all()


def _picked():
    """The PICK scenarios (state, hpolys, seg, reference times)."""
    sc = scenarios.random_scenarios(QCFG, 8, seed=SEED, min_seg=1)
    return sc.state[PICK], sc.hpolys[PICK], sc.seg[PICK], sc.times[PICK]


def _nets(dtype):
    net = ConvLSTMAllocNet(S, 256, config.SEQ10.model.token_thresh)
    net.load_state_dict(weights.load_params(WEIGHTS))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                           import_torch.load_params_msgpack(WEIGHTS))
    jnet = JConvLSTMAllocNet(seq_len=S, hidden_size=256, token_thresh=0.5)
    return net, jnet, jparams


def test_plan_batch_seq10_matches_jax():
    """The seq10 net and the 10-segment solve (f32): times and tokens to
    rtol 1e-5 (the same layer math), solved flags equal, coefficients of
    the scenarios both solve within 1e-3 of the largest; a 7-segment
    plan among them."""
    state, hpolys, seg, _ = (a[:2] for a in _picked())
    net, jnet, jparams = _nets(jnp.float32)
    res = pipeline.plan_batch(net, QCFG, SCFG, state, hpolys, seg,
                              device="cpu")
    jres = jax.tree.map(np.asarray, _jplan_batch(
        jnet, jparams, JQCFG, JSCFG, jnp.asarray(state, jnp.float32),
        jnp.asarray(hpolys, jnp.float32), jnp.asarray(seg, jnp.int32)))
    assert res.times.shape == (2, S)
    np.testing.assert_allclose(res.times.numpy(), jres.times, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res.tokens.numpy(), jres.tokens, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(res.solved.numpy(), jres.solved)
    np.testing.assert_array_equal(res.ok.numpy(), jres.ok)
    both = res.solved.numpy() & jres.solved
    c = res.coeffs.numpy()
    assert c.shape == (2, S, 3, 8) and np.isfinite(c).all()
    assert (seg[both] > 5).any()
    scale = max(1.0, float(np.abs(jres.coeffs[both]).max()))
    assert float(np.abs(c - jres.coeffs)[both].max()) <= 1e-3 * scale


def test_plan_batch_seq10_refines():
    """refine_steps=2 with the seq10 net (f64): each plan keeps its total of the 0.05-clamped times, no
    scenario solved without refinement is lost or ends up worse.  (The
    refinement loop itself is held against JAX at 5 segments,
    tests/test_torch_pipeline.py; it takes the segment count from cfg.)"""
    state, hpolys, seg, _ = (a[:2] for a in _picked())
    net = _nets(jnp.float64)[0].double()
    run = lambda k: pipeline.plan_batch(net, QCFG, SCFG, state, hpolys, seg,
                                        refine_steps=k, device="cpu")
    base, res = run(0), run(2)
    seg_mask = np.arange(S)[None, :] < seg[:, None]
    np.testing.assert_allclose(
        res.times.numpy().sum(1),
        np.where(seg_mask, np.maximum(base.times.numpy(), 0.05), 0).sum(1),
        rtol=1e-12)
    assert (res.times.numpy()[~seg_mask] == 0).all()
    b = base.solved.numpy()
    assert b.any() and res.solved.numpy()[b].all()
    assert (res.obj.numpy()[b] <= base.obj.numpy()[b] * (1 + 1e-9)).all()
    assert np.isfinite(res.coeffs.numpy()).all()


def test_plan_many_seq10_on_a_maze_matches_jax(monkeypatch):
    """tests/test_seq10_e2e.py's flow through both packages: the maze whose
    walls force a snaking route, plain RRT, the corridor (f64 on both
    sides), the seq10 net and the 10-segment QP.  Corridors, segment
    counts, network times and solved flags as the JAX plan_many; at least
    one corridor has more than 5 segments and is solved."""
    cfg = AllocNetConfig(qp=QCFG, solver=SCFG, model=config.SEQ10.model,
                         corridor=CorridorConfig(use_rrt_star=False))
    jcfg = JAllocNetConfig(qp=JQCFG, solver=JSCFG,
                           corridor=JCorridorConfig(use_rrt_star=False))
    pts = datagen.maze_map()
    np.testing.assert_array_equal(pts, _maze_map())
    lo, hi = [0, 0, 0], [40, 20, 4]
    pm = planner.build_map(pts, lo, hi, scale=0.25, dilate_r=2, device="cpu")
    jpm = jplanner.build_map(pts, lo, hi, scale=0.25, dilate_r=2)
    starts = np.array([[2.0, 10.0, 2.0], [2.0, 17.0, 2.0]])
    goals = np.array([[38.0, 10.0, 2.0], [38.0, 3.0, 2.0]])
    net, jnet, jparams = _nets(jnp.float32)
    out = planner.plan_many(pm, starts, goals, net, None, cfg,
                            device="cpu", dtype=torch.float64)
    monkeypatch.setattr(jpipeline, "plan_batch", _jplan_batch)
    jout = jplanner.plan_many(jpm, starts, goals, jnet, jparams, jcfg)
    assert out.reasons == jout.reasons
    np.testing.assert_array_equal(out.corridor_ok, jout.corridor_ok)
    segs = out.traj.seg_mask.numpy().sum(-1).astype(int)
    np.testing.assert_array_equal(segs, np.asarray(jout.traj.seg_mask).sum(-1))
    res, jres = out.result, jax.tree.map(np.asarray, jout.result)
    np.testing.assert_allclose(res.times.numpy(), jres.times, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(res.solved.numpy(), jres.solved)
    long_ok = out.corridor_ok & res.solved.numpy() & (segs > 5)
    assert long_ok.any(), (segs, out.reasons)
    c = res.coeffs.numpy()
    assert c.shape == (2, S, 3, 8) and np.isfinite(c).all()
    scale = max(1.0, float(np.abs(jres.coeffs[long_ok]).max()))
    assert float(np.abs(c - jres.coeffs)[long_ok].max()) <= 1e-3 * scale


def test_training_step_seq10_matches_jax():
    """One training step's loss and gradient norm with the seq10 net at
    max_seg=10, f64 on both sides (the same formulas through the
    differentiable QP, one scenario of three solved): to rtol 1e-6."""
    batch = _picked()
    net, jnet, jparams = _nets(jnp.float64)
    net = net.double()
    total, bundle = train_step.loss_fn(
        net, QCFG, SCFG, LossConfig(), *(torch.tensor(a) for a in batch),
        0.5)
    total.backward()
    gnorm = float(torch.sqrt(sum((p.grad ** 2).sum()
                                 for p in net.parameters())))
    grad = jax.jit(jax.value_and_grad(
        lambda p, *a: jts.loss_fn(p, jnet, JQCFG, JSCFG, JLossConfig(), *a,
                                  0.5), has_aux=True))
    (jtotal, jb), jgrad = grad(jparams, *(jnp.asarray(a) for a in batch))
    jnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                               for g in jax.tree.leaves(jgrad))))
    assert 0 < float(bundle.success_rate) < 1
    assert np.isfinite(float(total)) and gnorm > 0
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose(float(bundle.success_rate),
                               float(jb.success_rate))
    np.testing.assert_allclose(gnorm, jnorm, rtol=1e-6)


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    print("chunk against the f64 chunk on the same inputs, max over x, z, "
          "yh, yeh of max|diff| / max(1, max|f64|)")
    print(f"{'S':>3} {'res':>4} {'B':>3} {'seed':>4} {'iters':>5}  "
          f"{'applied':>7} {'port':>9} {'port f32 sum':>12} {'K1':>9}")
    for max_seg in (5, S):
        for case in CHUNK_CASES:
            for kx_t in (False, True):
                errs = chunk_errors(*case, max_seg, kx_t)
                m = {k: max(v.values()) for k, v in errs.items()}
                # K1 given Kx^T's transpose agrees with neither
                # orientation's f64 chunk: it is held in its own only
                k1 = "-" if kx_t else f"{m['K1']:.2e}"
                print(f"{max_seg:>3} {case[0]:>4} {case[1]:>3} {case[2]:>4} "
                      f"{case[3]:>5}  {'Kx' if kx_t else 'Kx^T':>7} "
                      f"{m['port']:9.2e} {m['port_f32_sum']:12.2e} "
                      f"{k1:>9}", flush=True)


if __name__ == "__main__":
    main()
