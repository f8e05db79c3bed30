"""Port parity, the fused ADMM chunk: allocnet_tpu_torch.ops.admm_chunk's
plain version against the TPU kernel (admm_tiled.run_chunk in interpret
mode) on the same inputs, packed into each side's layout (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.ops import admm as jadmm
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu.ops.pallas import admm_tiled as K1
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, admm_chunk, qp
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

SIGMA, ALPHA = 1e-6, 1.6


def _inputs(res, B, seed):
    """The same chunk inputs for both sides: seeded scenarios, a random
    primal/dual state and random per-scenario rho."""
    cfg, jcfg = QPConfig(res=res), JQPConfig(res=res)
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
    arrs = [sc.state.astype(np.float32), sc.hpolys.astype(np.float32),
            sc.times.astype(np.float32), sc.seg]
    data = qp.build_qp(cfg, *arrs, device="cpu")
    jdata = jqp.build_qp(jcfg, *(jnp.asarray(a) for a in arrs))
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.normal(size=(B, cfg.max_seg, 3, cfg.D))).astype(np.float32)
    z = jadmm._project(jqp.apply_A(jdata, jnp.asarray(x)), jqp.eq_rhs(jdata),
                       jqp.ineq_rhs(jdata))
    y = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in z.items()}
    rho_i = rng.uniform(1.0, 5.0, size=B).astype(np.float32)
    return cfg, jcfg, data, jdata, x, z, y, rho_i


def _run_both(res, B, seed, n_iters):
    cfg, jcfg, data, jdata, x, z, y, rho_i = _inputs(res, B, seed)
    rho_e = rho_i * 100.0
    NQ, NRR, MEQ = K1.dims(jcfg)
    M = jqp.normal_matrix(jdata, SIGMA, jnp.asarray(rho_e), jnp.asarray(rho_i))
    Minv = jadmm.spd_inverse(M)
    # K1's packing, straight from the JAX package
    kx = K1._fused_refined_inverse(M, Minv, NQ)
    nx, ny, nz, h, rmask, aeq, beq = K1._pack_scenario(jdata)
    cbig = K1._cbig_np(jcfg)
    ri, re = jnp.asarray(rho_i), jnp.asarray(rho_e)
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    state = (K1._x_pack(jnp.asarray(x), jcfg, NQ), K1._ineq_pack(z, jcfg, NRR),
             K1._ineq_pack(jy, jcfg, NRR) / ri[:, None, None],
             K1._yeq_pack(jy, MEQ) / re[:, None, None])
    mats = (kx, aeq, nx, ny, nz, h, rmask, beq, ri[:, None], re[:, None],
            (1e6 / ri)[:, None, None], (1e6 / re)[:, None, None])
    out = K1.run_chunk(jcfg, (jnp.asarray(cbig), jnp.asarray(cbig.T.copy())),
                       mats, state, n_iters, SIGMA, ALPHA, B, interpret=True)
    jx = K1._x_unpack(out[0], jcfg, jnp.float32).reshape(B, -1)
    jz = K1._ineq_unpack(out[1], jcfg, jnp.float32)
    jyh = K1._ineq_unpack(out[2], jcfg, jnp.float32)
    jyeh = K1._yeq_unpack(out[3], jcfg, jnp.float32)

    # the port's layout, from the port's own packing
    n = cfg.n_var
    M_t = torch.tensor(np.asarray(M))
    Minv_t = torch.tensor(np.asarray(Minv))
    aval_t, ablk_t, beq_t, nrm_t, h_t, sm_t, bas_t = admm_chunk.pack_scenario(data)
    T = lambda a: torch.tensor(np.asarray(a))
    args = (torch.tensor(x).reshape(B, n),
            admm_chunk.ineq_pack({k: T(z[k]) for k in qp.INEQ_KEYS}),
            admm_chunk.ineq_pack({k: T(y[k]) for k in qp.INEQ_KEYS})
            / T(rho_i)[:, None, None],
            qp.tree_flat({k: T(y[k]) for k in qp.EQ_KEYS}, qp.EQ_KEYS)
            / T(rho_e)[:, None],
            admm_chunk.fused_refined_inverse(M_t, Minv_t), aval_t, ablk_t,
            beq_t, nrm_t, h_t, sm_t, T(rho_i), T(rho_e), bas_t)
    before = admm_chunk.admm_chunk.launches
    px, pz, pyh, pyeh = admm_chunk.admm_chunk(*args, n_iters, SIGMA, ALPHA)
    assert admm_chunk.admm_chunk.launches == before   # CPU: no kernel launch
    want = dict(x=jx, z=admm_chunk.ineq_pack({k: T(v) for k, v in jz.items()}),
                yh=admm_chunk.ineq_pack({k: T(v) for k, v in jyh.items()}),
                yeh=qp.tree_flat({k: T(v) for k, v in jyeh.items()}, qp.EQ_KEYS))
    return dict(x=px, z=pz, yh=pyh, yeh=pyeh), want


# f32 on both sides, different summation order; ADMM amplifies roundoff
# through cond(M) ~ 1e4 (measured <= 1.5e-5 of each array's largest entry
# after 20 iterations), so 1e-4 of the largest entry.
@pytest.mark.parametrize("res,B,seed,n_iters", [(10, 8, 5, 1), (10, 8, 5, 20),
                                                 (20, 4, 11, 10)])
def test_chunk_reference_matches_tpu_kernel(res, B, seed, n_iters):
    got, want = _run_both(res, B, seed, n_iters)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
def test_structured_aeq_expands_to_dense_eq_bit_for_bit(L):
    """pack_aeq keeps every nonzero of qp.dense_eq's rows (at most two
    (segment, axis) blocks each) and aeq_dense puts them back, bit for bit,
    for every segment count and in f32 and f64 assembly."""
    cfg = QPConfig(res=4)
    for seed in (0, 1, 2):
        sc = scenarios.random_scenarios(cfg, 6, seed=seed, min_seg=L,
                                        max_seg=L)
        for dt in (np.float32, np.float64):
            data = qp.build_qp(cfg, sc.state.astype(dt), sc.hpolys.astype(dt),
                               sc.times.astype(dt), sc.seg, device="cpu")
            aeq, _ = qp.dense_eq(data)
            aeq = aeq.to(torch.float32)
            val, blk = admm_chunk.pack_aeq(aeq, cfg.max_seg)
            assert val.shape == (6, cfg.n_eq, 2, cfg.D)
            assert blk.dtype == torch.int32
            assert bool((blk[..., 0] != blk[..., 1]).all())
            back = admm_chunk.aeq_dense(val, blk, cfg.n_var)
            assert torch.equal(back, aeq)
            # and the structured rows are the same equality operator
            x = torch.randn((6, cfg.n_var), dtype=torch.float32)
            ref = qp.tree_flat(qp.apply_A(data, x.to(data.times.dtype).view(
                6, cfg.max_seg, 3, cfg.D)), qp.EQ_KEYS)
            np.testing.assert_allclose(
                torch.einsum('bmn,bn->bm', back, x).numpy(),
                ref.to(torch.float32).numpy(), rtol=1e-5, atol=1e-5)


def _chunk_case(res, B, seed, warm):
    cfg, scfg = QPConfig(res=res), SolverConfig()
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device="cpu")
    x0y0 = admm_chunk.padded_noise(data, seed) if warm else ()
    return cfg, scfg, sc, data, admm_chunk.chunk_inputs(data, scfg, *x0y0)


def _skipped_parts_unchanged(cfg, args, out, Ls, face_live):
    """Every part live_parts skips is, after the dense chunk, exactly what
    it was on input."""
    B, S, R, F = args[0].shape[0], cfg.max_seg, cfg.res, cfg.max_faces
    seg_dead = torch.arange(S)[None, :] >= Ls[:, None]
    x_in, x_out = args[0].view(B, S, -1), out[0].view(B, S, -1)
    assert torch.equal(x_out[seg_dead], x_in[seg_dead])
    for t_in, t_out in ((args[1], out[1]), (args[2], out[2])):
        t_in, t_out = t_in.view(B, S, R, -1), t_out.view(B, S, R, -1)
        assert torch.equal(t_out[seg_dead], t_in[seg_dead])
        dead = (~face_live)[:, :, None, :].expand(B, S, R, F)
        assert torch.equal(t_out[..., :F][dead], t_in[..., :F][dead])


def test_kernel_skip_rule_is_exact_on_a_cold_start():
    """On the main path's inputs (zero warm start) the kernel's load-time
    rule skips the padded segments and face slots, and the dense iteration
    leaves exactly those parts at zero."""
    cfg, scfg, sc, data, args = _chunk_case(10, 12, 3, warm=False)
    Ls, face_live = admm_chunk.live_parts(*args)
    np.testing.assert_array_equal(Ls.numpy(), sc.seg)
    assert torch.equal(face_live, data.face_mask > 0)
    out = admm_chunk.admm_chunk(*args, 20, scfg.sigma, scfg.alpha)
    _skipped_parts_unchanged(cfg, args, out, Ls, face_live)


def test_kernel_skip_rule_fails_on_a_nonzero_padded_warm_start():
    """A warm start with nonzero padded state: the rule keeps every segment
    and face slot of those scenarios live (the kernel does the dense work
    there), and the dense iteration does move their padded parts, so
    skipping them would be wrong.  The clean scenarios of the same batch
    still skip."""
    cfg, scfg, sc, data, args = _chunk_case(10, 12, 3, warm=True)
    Ls, face_live = admm_chunk.live_parts(*args)
    noisy = np.arange(12) % 2 == 0
    np.testing.assert_array_equal(Ls.numpy()[noisy], cfg.max_seg)
    assert bool(face_live[torch.as_tensor(noisy)].all())
    np.testing.assert_array_equal(Ls.numpy()[~noisy], sc.seg[~noisy])
    out = admm_chunk.admm_chunk(*args, 20, scfg.sigma, scfg.alpha)
    _skipped_parts_unchanged(cfg, args, out, Ls, face_live)
    B, S = 12, cfg.max_seg
    padded = torch.arange(S)[None, :] >= torch.as_tensor(sc.seg)[:, None]
    moved = (out[0] - args[0]).view(B, S, -1).abs().amax(-1)
    assert bool((moved[padded & torch.as_tensor(noisy)[:, None]] > 0).all())


def test_kernel_skip_rule_keeps_everything_live_on_nonfinite_input():
    cfg, scfg, sc, data, args = _chunk_case(4, 3, 1, warm=False)
    args = list(args)
    args[4] = args[4].clone()
    args[4][1, 0, 0] = float("nan")
    Ls, face_live = admm_chunk.live_parts(*args)
    assert int(Ls[1]) == cfg.max_seg and bool(face_live[1].all())
    np.testing.assert_array_equal(Ls.numpy()[[0, 2]], sc.seg[[0, 2]])


def test_layout_packing_roundtrip():
    cfg, _, data, _, x, z, y, _ = _inputs(10, 3, 2)
    tree = {k: torch.tensor(np.asarray(z[k])) for k in qp.INEQ_KEYS}
    back = admm_chunk.ineq_unpack(admm_chunk.ineq_pack(tree), cfg)
    for k in qp.INEQ_KEYS:
        np.testing.assert_array_equal(back[k].numpy(), tree[k].numpy())
    eq = {k: torch.tensor(y[k]) for k in qp.EQ_KEYS}
    back = admm_chunk.yeq_unpack(qp.tree_flat(eq, qp.EQ_KEYS), cfg)
    for k in qp.EQ_KEYS:
        np.testing.assert_array_equal(back[k].numpy(), eq[k].numpy())
    # h: corridor offsets then the 12 box bounds, the same for every sample
    _, _, _, _, h, _, _ = admm_chunk.pack_scenario(data)
    hf = qp.ineq_rhs(data)
    np.testing.assert_array_equal(
        admm_chunk.ineq_pack(hf).reshape(3, cfg.max_seg, cfg.res, -1).numpy(),
        h[:, :, None, :].expand(-1, -1, cfg.res, -1).numpy())


def _valid_args(B=2, res=4):
    cfg = QPConfig(res=res)
    S, R, F, D, n, m = cfg.max_seg, cfg.res, cfg.max_faces, cfg.D, cfg.n_var, cfg.n_eq
    C = F + 12
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    return [z(B, n), z(B, S * R, C), z(B, S * R, C), z(B, m), z(B, n, n),
            z(B, m, 2, D), torch.zeros((B, m, 2), dtype=torch.int32), z(B, m),
            z(B, S, F, 3), torch.ones(B, S, C), z(B, S), torch.ones(B),
            torch.ones(B), z(3, R, D)]


@pytest.mark.parametrize("case", ["dtype", "shape", "contig", "device"])
def test_wrapper_rejects_bad_input(case):
    args = _valid_args()
    if case == "dtype":
        args[4] = args[4].double()
    elif case == "shape":
        args[1] = args[1][:, :-1]
    elif case == "contig":
        args[4] = args[4].transpose(1, 2)
    else:
        args[10] = args[10].to("meta")
    with pytest.raises((TypeError, ValueError)):
        admm_chunk.admm_chunk(*args, 3, SIGMA, ALPHA)


def test_wrapper_zero_state_stays_zero():
    out = admm_chunk.admm_chunk(*_valid_args(), 3, SIGMA, ALPHA)
    for t in out:
        assert float(t.abs().max()) == 0.0


def test_chunked_core_rejects_f64():
    """The fused chunk is f32: the loop around it raises on an f64 QP rather
    than rounding it (solve_qp sends f64 to admm.admm_solve on the CPU)."""
    cfg = QPConfig(res=4)
    sc = scenarios.random_scenarios(cfg, 2, seed=1, min_seg=1)
    data = qp.build_qp(cfg, sc.state, sc.hpolys, sc.times, sc.seg,
                       device="cpu")
    assert data.times.dtype == torch.float64
    with pytest.raises(TypeError):
        admm_chunk.admm_solve_chunked(data, SolverConfig(n_chunks=1,
                                                         iters_per_chunk=2))


def test_chunked_core_tracks_plain_core():
    """admm_solve_chunked (the loop around the kernel) and admm_solve reach the
    same ADMM point in f32 up to the chunk's Kx^T and scaled-dual rounding:
    residuals of the same order on every scenario."""
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 8, seed=5, min_seg=1)
    data = qp.build_qp(cfg, sc.state.astype(np.float32),
                       sc.hpolys.astype(np.float32),
                       sc.times.astype(np.float32), sc.seg, device="cpu")
    scfg = SolverConfig(n_chunks=2, iters_per_chunk=75)
    a = admm_chunk.admm_solve_chunked(data, scfg)
    b = admm.admm_solve(data, scfg)
    assert a[0].shape == b[0].shape and a[0].dtype == torch.float32
    np.testing.assert_allclose(a[4].numpy(), b[4].numpy(), rtol=1e-3)
    # both converge to within 2e-3 primal on every scenario here
    assert float(a[5].max()) < 2e-2 and float(b[5].max()) < 2e-2
    scale = max(1.0, float(b[0].abs().max()))
    assert float((a[0] - b[0]).abs().max()) <= 5e-2 * scale
