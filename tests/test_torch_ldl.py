"""Port parity, the polish's LDL^T: allocnet_tpu_torch.ops.ldl against
allocnet_tpu.ops.ldl on the CPU, where the diagonal block runs the plain
version of the kernel csrc/ldl_block.cu (the column loop).

Inputs: the KKT systems the port's polish really factors (captured from
`admm.solve_qp` on seeded scenarios at the deploy shape, kdim 250 padded to
256 in 4 blocks, and at ten segments, 430 padded to 448 in 7 blocks), and
seeded numpy blocks.  Tolerances: the port divides by each pivot where JAX
multiplies by its reciprocal, one rounding per entry that the pivots of
1e-5 amplify; in f64 that leaves 1e-9 of each array's largest entry, in
f32 5e-3 on a block (measured <= 9.8e-4), and the refined solutions of
f32 factors agree to 1e-3 of the largest entry (measured 3.7e-5 between
the sides, 6.0e-5 from the f64 solve), the JAX package's own bar for an
f32 factor against the f64 solve (tests/test_ldl.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.ops import ldl as jldl
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import _cuda_build, admm, ldl, qp
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

REG = 1e-5                 # SolverConfig.polish_ldl_delta
NB = 64
TOL = {torch.float64: 1e-9, torch.float32: 5e-3}
SOLVE_TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
REFINE_STEPS = 3           # SolverConfig.polish_refine_steps + 1


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _jax(Kb, sign):
    return jldl._ldl_unblocked(jnp.asarray(Kb.numpy()),
                               jnp.asarray(sign.numpy()), REG)


_CAPTURED = {}


def _polish_kkt(max_seg, dtype):
    """The first KKT the port's polish factors on 4 seeded scenarios of
    max_seg - 1 or max_seg segments (res 4: the KKT's size does not depend
    on res): (K padded (B, N, N), sign (N,), the first right-hand side
    (B, N), the diagonal blocks that `ldl_block` got, each with its
    signs)."""
    key = (max_seg, dtype)
    if key not in _CAPTURED:
        cfg = QPConfig(res=4, max_seg=max_seg)
        sc = scenarios.random_scenarios(cfg, 4, seed=3, min_seg=max_seg - 1)
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        data = qp.build_qp(cfg, sc.state.astype(np_dt),
                           sc.hpolys.astype(np_dt), sc.times.astype(np_dt),
                           sc.seg, device="cpu")
        rec = {"blocks": []}
        factor, solve, block = ldl.ldl_factor, ldl.ldl_solve, ldl.ldl_block

        def rec_factor(K, **kw):
            rec.setdefault("factor", (K.clone(), kw["sign"].clone()))
            return factor(K, **kw)

        def rec_solve(L, d, rhs):
            rec.setdefault("rhs", rhs.clone())
            return solve(L, d, rhs)

        def rec_block(Kb, sign, reg):
            if len(rec["blocks"]) < rec["factor"][0].shape[1] // NB:
                rec["blocks"].append((Kb.clone(), sign.clone()))
            return block(Kb, sign, reg)

        ldl.ldl_factor, ldl.ldl_solve, ldl.ldl_block = (rec_factor,
                                                         rec_solve, rec_block)
        try:
            admm.solve_qp(data, SolverConfig())
        finally:
            ldl.ldl_factor, ldl.ldl_solve, ldl.ldl_block = factor, solve, block
        K, sign = rec["factor"]
        sign = torch.cat([sign, sign.new_ones(K.shape[1] - sign.shape[0])])
        _CAPTURED[key] = (K, sign, rec["rhs"], rec["blocks"])
    return _CAPTURED[key]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("max_seg,n_blocks", [(5, 4), (10, 7)])
def test_polish_blocks_match_jax(max_seg, n_blocks, dtype):
    """Every diagonal block of a polish factorization (after the trailing
    updates of the blocks before it) with the polish's sign pattern: PD
    coefficient slots, constraint rows, P-null slots, padding."""
    K, sign, _, blocks = _polish_kkt(max_seg, dtype)
    assert K.shape[1] == n_blocks * NB and len(blocks) == n_blocks
    assert (sign > 0).any() and (sign < 0).any()
    for s, (Kb, sg) in enumerate(blocks):
        torch.testing.assert_close(sg, sign[s * NB:(s + 1) * NB])
        L, d = ldl.ldl_block(Kb, sg, REG)
        jL, jd = _jax(Kb, sg)
        assert _rel(L, jL) <= TOL[dtype], (s, _rel(L, jL))
        assert _rel(d, jd) <= TOL[dtype], (s, _rel(d, jd))
        assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
        assert torch.equal(L.diagonal(dim1=1, dim2=2), torch.ones_like(d))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bumped_pivots_keep_the_unbumped_diagonal(dtype):
    """Pivots below `reg` (zero, tiny, and tiny with the wrong sign) are
    bumped to sign * reg for the division, and d keeps the unbumped value
    on both sides."""
    rng = np.random.default_rng(11)
    B = 3
    W = rng.normal(size=(B, NB, NB))
    K = W @ np.swapaxes(W, 1, 2) / NB + np.eye(NB)
    sign = np.where(np.arange(NB) < 40, 1.0, -1.0)
    K[:, 40:, 40:] = -K[:, 40:, 40:]
    K[:, :40, 40:] *= 0.1
    K[:, 40:, :40] *= 0.1
    small = {5: 0.0, 20: 3e-8, 45: 2e-9, 50: -4e-7}
    for j, v in small.items():
        # no coupling to the columns before j: the pivot is K[j, j] itself
        K[:, j, :j] = K[:, :j, j] = 0.0
        K[:, j, j] = v
    Kb = torch.tensor(K, dtype=dtype)
    sg = torch.tensor(sign, dtype=dtype)
    L, d = ldl.ldl_block(Kb, sg, REG)
    jL, jd = _jax(Kb, sg)
    for j, v in small.items():
        want = float(torch.tensor(v, dtype=dtype))
        assert (d[:, j] == want).all() and (np.asarray(jd)[:, j] == want).all()
        # column j below the diagonal was divided by the bumped pivot
        col = Kb[:, j + 1:, j] / (sg[j] * REG)
        torch.testing.assert_close(L[:, j + 1:, j], col, rtol=1e-5, atol=0)
    assert _rel(L, jL) <= TOL[dtype] and _rel(d, jd) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padding_columns_match_jax(dtype):
    """The last block of a padded KKT: 58 columns of a quasi-definite
    system, then 6 identity columns of sign +1 (`pad_to_block`)."""
    rng = np.random.default_rng(12)
    n = 58
    W = rng.normal(size=(2, n, n))
    A = W @ np.swapaxes(W, 1, 2) / n + 1e-2 * np.eye(n)
    A[:, 30:, 30:] = -A[:, 30:, 30:]
    A[:, :30, 30:] *= 0.1
    A[:, 30:, :30] *= 0.1
    sign = np.where(np.arange(n) < 30, 1.0, -1.0)
    Kp, _, N = ldl.pad_to_block(torch.tensor(A, dtype=dtype),
                                torch.zeros((2, n), dtype=dtype), NB)
    assert Kp.shape[1] == NB and N == n
    sg = torch.cat([torch.tensor(sign, dtype=dtype),
                    torch.ones(NB - n, dtype=dtype)])
    L, d = ldl.ldl_block(Kp, sg, REG)
    jL, jd = _jax(Kp, sg)
    assert _rel(L, jL) <= TOL[dtype] and _rel(d, jd) <= TOL[dtype]
    eye = torch.eye(NB - n, dtype=dtype).expand(2, -1, -1)
    for LL, dd in ((L, d), (torch.tensor(np.asarray(jL)),
                            torch.tensor(np.asarray(jd)))):
        assert torch.equal(LL[:, n:, n:], eye)
        assert torch.equal(LL[:, n:, :n], torch.zeros_like(LL[:, n:, :n]))
        assert torch.equal(dd[:, n:], torch.ones_like(dd[:, n:]))


@pytest.mark.parametrize("max_seg,dtype", [(5, torch.float64),
                                           (10, torch.float64),
                                           (5, torch.float32)])
def test_factor_solve_refine_match_jax(max_seg, dtype):
    """The blocked factor, the solve and REFINE_STEPS refinement steps
    against the factored KKT (as tests/test_ldl.py refines), on both sides,
    against the f64 direct solve.  Not at ten segments in f32: there both
    sides' f32 pivots carry errors of up to 0.5 of themselves (measured
    0.48 and 0.27), and the refinement converges on some scenarios and
    not on others, differently on each side."""
    K, sign, rhs, _ = _polish_kkt(max_seg, dtype)
    L, d = ldl.ldl_factor(K, nb=NB, reg=REG, sign=sign)
    jL, jd = jldl.ldl_factor(jnp.asarray(K.numpy()), nb=NB, reg=REG,
                             sign=jnp.asarray(sign.numpy()))
    assert L.shape == K.shape and d.shape == K.shape[:2]
    Kn, r = K.numpy(), rhs.numpy()

    def refine(solve):
        x = solve(r)
        for _ in range(REFINE_STEPS):
            x = x - solve(np.einsum('bij,bj->bi', Kn, x) - r)
        return x

    x = refine(lambda v: ldl.ldl_solve(L, d, torch.as_tensor(v)).numpy())
    jx = refine(lambda v: np.asarray(jldl.ldl_solve(jL, jd, jnp.asarray(v))))
    ref = np.linalg.solve(Kn.astype(np.float64),
                          r.astype(np.float64)[..., None])[..., 0]
    assert _rel(x, jx) <= SOLVE_TOL[dtype]
    assert _rel(x, ref) <= SOLVE_TOL[dtype]
    assert _rel(jx, ref) <= SOLVE_TOL[dtype]


def test_cpu_operator_is_the_column_loop(monkeypatch):
    """On CPU tensors the operator runs `ldl_block_reference` and launches
    nothing."""
    K, sign, _, blocks = _polish_kkt(5, torch.float32)
    Kb, sg = blocks[1]
    calls = []
    ref = ldl.ldl_block_reference
    monkeypatch.setattr(ldl, "ldl_block_reference",
                        lambda *a: calls.append(a) or ref(*a))
    before = ldl.ldl_block.launches
    L, d = ldl.ldl_block(Kb, sg, REG)
    assert len(calls) == 1 and calls[0][0] is Kb
    assert ldl.ldl_block.launches == before
    rL, rd = ref(Kb, sg, REG)
    assert torch.equal(L, rL) and torch.equal(d, rd)


def test_operator_refuses_bad_input():
    K, sign, _, blocks = _polish_kkt(5, torch.float32)
    Kb, sg = blocks[0]
    with pytest.raises(ValueError, match="contiguous"):
        ldl.ldl_block(K[:, :NB, :NB], sg, REG)
    with pytest.raises(ValueError, match="sign has shape"):
        ldl.ldl_block(Kb, sg[:-1].contiguous(), REG)
    with pytest.raises(TypeError):
        ldl.ldl_block(Kb, sg.double(), REG)
    with pytest.raises(TypeError):
        ldl.ldl_block(Kb.half(), sg.half(), REG)
    # the card's implementation checks before it touches the card: f32
    # only, at most 64 columns
    with pytest.raises(TypeError, match="float32"):
        ldl._ldl_block_cuda(Kb.double(), sg.double(), REG)
    big = torch.eye(NB + 1).expand(2, -1, -1).contiguous()
    with pytest.raises(ValueError, match="at most 64"):
        ldl._ldl_block_cuda(big, torch.ones(NB + 1), REG)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the kernel's build raises."""
    old = ldl.BUILD_DIR
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda_build, "CUDA_NVCC", str(tmp_path / "nvcc"))
    ldl.set_build_dir(tmp_path / "build")
    try:
        with pytest.raises(RuntimeError, match="nvcc not found.*ldl_block"):
            ldl.build()
        assert list((tmp_path / "build").iterdir()) == []
    finally:
        ldl.set_build_dir(old)
