"""The polish's LDL^T block kernel (csrc/ldl_block.cu) on the card: against
its plain version `ldl_block_reference` on the same card, on the diagonal
blocks that the polish factors and on random blocks, at batch sizes that
leave a thread block's last warps without a scenario and at block sizes
other than the polish's 64, the operator's dispatch, the fast start's
library and the polish's solutions through it.
Skips without a CUDA device.  Run on the card with

    python -m pytest tests/test_torch_gpu_ldl.py -m gpu --noconftest -o addopts=''

This file imports no JAX, so it runs where only PyTorch is installed.

Tolerance: none on finite input.  The kernel does the plain version's
IEEE operations in its order without FMA contraction, so the two agree
bit for bit (`ops/ldl.py`, `csrc/ldl_block.cu`)."""

import json
import os

import numpy as np
import pytest
import torch

from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       QPConfig, SolverConfig)
from allocnet_tpu_torch.ops import _cuda_build, admm, admm_chunk, ldl, qp
from allocnet_tpu_torch.planner import driver, native
from allocnet_tpu_torch.utils import bench_ldl, scenarios
from tests.test_torch_gpu_drive import ConstTimeNet

REG = 1e-5                 # SolverConfig.polish_ldl_delta
NB = 64
# the polish's solutions through the kernel and through the plain version
SOL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _polish_blocks(cfg, B, dev, seed=5):
    """The diagonal blocks (and their signs) of the first factorization of
    `admm.solve_qp` on B seeded scenarios, captured on `dev`."""
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=dev)
    blocks, block = [], ldl.ldl_block
    n_blocks = -(-(cfg.n_var + cfg.n_eq + SolverConfig().max_active) // NB)

    def rec(Kb, sign, reg):
        if len(blocks) < n_blocks:
            blocks.append((Kb.clone(), sign.clone()))
        return block(Kb, sign, reg)

    ldl.ldl_block = rec
    try:
        admm.solve_qp(data, SolverConfig())
    finally:
        ldl.ldl_block = block
    assert len(blocks) == n_blocks
    return blocks


def _random_blocks(B, dev, seed=0):
    """Seeded quasi-definite blocks (40 positive pivots, 24 negative) with
    pivots below REG in columns 5, 20, 45 and 50."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(B, NB, NB))
    K = W @ np.swapaxes(W, 1, 2) / NB + np.eye(NB)
    K[:, 40:, 40:] = -K[:, 40:, 40:]
    K[:, :40, 40:] *= 0.1
    K[:, 40:, :40] *= 0.1
    for j, v in ((5, 0.0), (20, 3e-8), (45, 2e-9), (50, -4e-7)):
        K[:, j, :j] = K[:, :j, j] = 0.0
        K[:, j, j] = v
    sign = np.where(np.arange(NB) < 40, 1.0, -1.0)
    return (torch.tensor(K, dtype=torch.float32, device=dev),
            torch.tensor(sign, dtype=torch.float32, device=dev))


def _launch_and_compare(Kb, sign):
    before = ldl.ldl_block.launches
    L, d = ldl.ldl_block(Kb, sign, REG)
    torch.cuda.synchronize()
    assert ldl.ldl_block.launches == before + 1
    rL, rd = ldl.ldl_block_reference(Kb, sign, REG)
    assert torch.isfinite(L).all() and torch.isfinite(d).all()
    assert torch.equal(L, rL), float((L - rL).abs().max())
    assert torch.equal(d, rd), float((d - rd).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 4, 256, 1024])
def test_kernel_equals_plain_on_polish_blocks(cuda, B):
    for Kb, sign in _polish_blocks(QPConfig(res=10), B, cuda):
        _launch_and_compare(Kb, sign)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 4, 256, 1024])
def test_kernel_equals_plain_on_random_blocks(cuda, B):
    _launch_and_compare(*_random_blocks(B, cuda, seed=B))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [5, 7, 1023, 1025])
def test_kernel_equals_plain_with_a_partial_last_thread_block(cuda, B):
    """Batches that are not a multiple of the scenarios per thread block:
    the last block's spare warps return at once and wait on nothing."""
    assert ldl.geometry()["warps_per_block"] == 4
    _launch_and_compare(*_random_blocks(B, cuda, seed=B))


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 17, 60, 63])
def test_kernel_equals_plain_at_other_block_sizes(cuda, nb):
    """Blocks of other than 64 columns with bumped pivots: 4-byte loads
    and stores where nb % 4 != 0, 16-byte ones at 60."""
    Kb, sign = bench_ldl.random_qd_blocks(9, cuda, seed=nb, nb=nb)
    assert bool((ldl.ldl_block_reference(Kb, sign, REG)[1].abs()
                 < REG).any())
    _launch_and_compare(Kb, sign)


@pytest.mark.gpu
def test_kernel_on_a_misaligned_block(cuda):
    """K 4 bytes off a 16-byte boundary (a contiguous view into a larger
    buffer): the kernel takes 4-byte loads and equals the plain version."""
    Kb, sign = _random_blocks(6, cuda, seed=3)
    buf = torch.empty(Kb.numel() + 1, device=cuda)
    view = buf[1:].view(Kb.shape)
    view.copy_(Kb)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _launch_and_compare(view, sign)


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda):
    Kb, sign = _random_blocks(1, cuda)
    before = ldl.ldl_block.launches
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        L, d = ldl.ldl_block(Kb[:0], sign, REG)
        torch.cuda.synchronize()
    assert ldl.ldl_block.launches == before
    assert not [ev for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name.startswith("ldl_block_kernel")]
    assert L.shape == (0, NB, NB) and d.shape == (0, NB)
    assert L.device == Kb.device and L.dtype == torch.float32


@pytest.mark.gpu
def test_non_finite_scenario_leaves_its_thread_block_alone(cuda):
    """B=8 with a NaN in scenario 5 only (the second thread block holds
    scenarios 4-7): scenario 5 gets NaN in all of d and of L's strict
    lower triangle, the other seven equal the plain version."""
    Kb, sign = _random_blocks(8, cuda, seed=11)
    Kb[5, 40, 7] = float("nan")
    L, d = ldl.ldl_block(Kb, sign, REG)
    rL, rd = ldl.ldl_block_reference(Kb, sign, REG)
    torch.cuda.synchronize()
    strict = torch.tril(torch.ones(NB, NB, dtype=torch.bool, device=cuda), -1)
    assert torch.isnan(d[5]).all() and torch.isnan(L[5][strict]).all()
    assert torch.equal(L[5].diagonal(), torch.ones_like(d[5]))
    assert torch.equal(torch.triu(L[5], 1), torch.zeros_like(L[5]))
    for b in (0, 1, 2, 3, 4, 6, 7):
        assert torch.equal(L[b], rL[b]) and torch.equal(d[b], rd[b]), b


@pytest.mark.gpu
def test_kernel_on_ten_segment_blocks(cuda):
    blocks = _polish_blocks(QPConfig(res=10, max_seg=10), 64, cuda)
    assert len(blocks) == 7
    for Kb, sign in blocks:
        _launch_and_compare(Kb, sign)


@pytest.mark.gpu
def test_non_finite_scenario(cuda):
    """A NaN below the diagonal of scenario 1 and an inf above it in
    scenario 2: their d is not finite on both sides; the kernel gives NaN
    in all of d and in L's strict lower triangle, and the other scenarios
    equal the plain version."""
    Kb, sign = _random_blocks(4, cuda, seed=7)
    Kb[1, 30, 12] = float("nan")
    Kb[2, 10, 33] = float("inf")
    L, d = ldl.ldl_block(Kb, sign, REG)
    rL, rd = ldl.ldl_block_reference(Kb, sign, REG)
    torch.cuda.synchronize()
    for b in (1, 2):
        assert not torch.isfinite(rd[b]).all()
        assert torch.isnan(d[b]).all()
        assert torch.isnan(torch.tril(L[b], -1)[torch.tril(
            torch.ones_like(L[b], dtype=torch.bool), -1)]).all()
        assert torch.equal(L[b].diagonal(), torch.ones_like(d[b]))
        assert torch.equal(torch.triu(L[b], 1), torch.zeros_like(L[b]))
    for b in (0, 3):
        assert torch.equal(L[b], rL[b]) and torch.equal(d[b], rd[b])


@pytest.mark.gpu
def test_operator_on_cuda_runs_the_kernel_only(cuda, monkeypatch):
    """torch.ops.allocnet_torch.ldl_block on CUDA tensors launches the
    kernel once (counter and profiler) and never the column loop."""
    Kb, sign = _random_blocks(8, cuda)
    want = ldl.ldl_block_reference(Kb, sign, REG)

    def loop(*a):
        raise AssertionError("the column loop ran on CUDA tensors")

    monkeypatch.setattr(ldl, "ldl_block_reference", loop)
    torch.cuda.synchronize()
    before = ldl.ldl_block.launches
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        L, d = torch.ops.allocnet_torch.ldl_block(Kb, sign, REG)
        torch.cuda.synchronize()
    assert ldl.ldl_block.launches == before + 1
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0].startswith("ldl_block_kernel"), \
        kernels
    assert torch.equal(L, want[0]) and torch.equal(d, want[1])


@pytest.mark.gpu
def test_operator_refuses_what_the_kernel_cannot_take(cuda):
    Kb, sign = _random_blocks(2, cuda)
    with pytest.raises(ValueError, match="sign on"):
        ldl.ldl_block(Kb, sign.cpu(), REG)
    with pytest.raises(ValueError, match="sign on"):
        ldl.ldl_block(Kb.cpu(), sign, REG)
    with pytest.raises(TypeError, match="float32"):
        ldl.ldl_block(Kb.double(), sign.double(), REG)
    with pytest.raises(ValueError, match="contiguous"):
        ldl.ldl_block(Kb.transpose(1, 2), sign, REG)
    big = torch.eye(NB + 1, device=cuda).expand(2, -1, -1).contiguous()
    with pytest.raises(ValueError, match="at most 64"):
        ldl.ldl_block(big, torch.ones(NB + 1, device=cuda), REG)


@pytest.mark.gpu
def test_polish_through_the_kernel_equals_the_plain_operator(cuda,
                                                             monkeypatch):
    """solve_qp on the card (deploy shape, B=256): the polish through the
    kernel, then through the plain version on the card, from the same
    inputs; and the kernel's launches: 4 blocks per factorization."""
    cfg = QPConfig()
    sc = scenarios.random_scenarios(cfg, 256, seed=123, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=cuda)
    before = ldl.ldl_block.launches
    sol = admm.solve_qp(data, SolverConfig())
    torch.cuda.synchronize()
    n = ldl.ldl_block.launches - before
    assert n > 0 and n % 4 == 0
    monkeypatch.setattr(ldl, "ldl_block", ldl.ldl_block_reference)
    plain = admm.solve_qp(data, SolverConfig())
    assert torch.equal(sol.solved, plain.solved)
    c, pc = sol.coeffs, plain.coeffs
    assert float((c - pc).abs().max()) <= SOL_TOL * max(
        1.0, float(pc.abs().max()))


@pytest.mark.gpu
def test_fast_start_carries_the_kernel_library(cuda, tmp_path, monkeypatch):
    """save_aot saves the LDL^T kernel's library beside the ADMM chunk's;
    a driver started from it with no compiler and an empty build
    directory takes both and solves a cold tick through both kernels (a
    net of constant 5 s segments on the fast start's box corridor)."""
    mods = (admm_chunk, ldl, native)
    dirs = [mod.BUILD_DIR for mod in mods]
    cfg = AllocNetConfig(qp=QPConfig(res=10),
                         solver=SolverConfig(n_chunks=2, iters_per_chunk=150),
                         corridor=CorridorConfig(use_rrt_star=False))
    net = ConstTimeNet(5.0, 5)
    aot = str(tmp_path / "aot")
    try:
        sizes = driver.Driver(net, None, cfg, device=cuda).save_aot(aot)
        manifest = json.load(open(os.path.join(aot, "manifest.json")))
        assert manifest["ldl"] == ldl.library_name()
        assert set(sizes) == {"kernel", "ldl", "native"}
        assert os.path.exists(os.path.join(aot, manifest["ldl"]))
        monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_cuda_build, "CUDA_NVCC",
                            str(tmp_path / "no_nvcc"))
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        cache = tmp_path / "cache"
        drv = driver.Driver(net, None, cfg, device=cuda,
                            cache_dir=str(cache), aot_path=aot)
        assert drv.aot_loaded
        assert sorted(os.listdir(cache)) == sorted(
            manifest[k] for k in ("kernel", "ldl", "native"))
        before = (admm_chunk.admm_chunk.launches, ldl.ldl_block.launches)
        out = drv._cold(*driver._aot_dummy_args(cfg, device=cuda))
        torch.cuda.synchronize()
        assert bool(out[0][0])
        assert admm_chunk.admm_chunk.launches > before[0]
        assert ldl.ldl_block.launches > before[1]
    finally:
        for mod, d in zip(mods, dirs):
            mod.set_build_dir(d)
