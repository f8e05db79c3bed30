"""Port parity, the application layer around the paths: utils/timing,
viz/artifacts and the command line (allocnet_tpu_torch/cli.py) against
allocnet_tpu's on the CPU.

Tolerances: the timer's records have the JAX module's keys and counts;
polytope vertices are the same SciPy computation (sets equal to 1e-8);
the plots and the CLI are held to writing their files."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from allocnet_tpu.utils import timing as jtiming
from allocnet_tpu.viz import artifacts as jartifacts
from allocnet_tpu_torch.config import PhysParams, QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.planner import trajectory
from allocnet_tpu_torch.train import dataset
from allocnet_tpu_torch.utils import scenarios, timing
from allocnet_tpu_torch.viz import artifacts
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERT_TOL = 1e-8


def _timer_records(mod, path):
    t = mod.PhaseTimer()
    for name in ("path+corridor", "inference", "qp+fill", "inference"):
        with t.phase(name):
            pass
    t.dump(path)
    return t.summary(), json.loads(open(path).read())


def test_phase_timer_matches_jax_format(tmp_path):
    got, got_line = _timer_records(timing, str(tmp_path / "t.jsonl"))
    want, want_line = _timer_records(jtiming, str(tmp_path / "j.jsonl"))
    assert list(got) == list(want) == ["path+corridor", "inference",
                                       "qp+fill"]
    for k in got:
        assert set(got[k]) == set(want[k]) == {"total_s", "count", "mean_ms"}
        assert got[k]["count"] == want[k]["count"]
    assert set(got_line) == set(want_line)
    assert got_line["inference"]["count"] == 2


def test_microbenchmark_and_device_trace_on_the_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    s = timing.microbenchmark(fn, torch.ones(64, 64), warmup=2, reps=3)
    assert s > 0 and len(calls) == 5
    with timing.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 100


def _vertex_sets_equal(a, b):
    a = a[np.lexsort(a.T)]
    b = b[np.lexsort(b.T)]
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=VERT_TOL)


def test_polytope_mesh_matches_jax():
    sc = scenarios.random_scenarios(QPConfig(res=10), 2, seed=9, min_seg=2,
                                    extra_faces=3)
    n = 0
    for hp in sc.hpolys[:, 0]:
        live = hp[np.linalg.norm(hp[:, :3], axis=1) > 0]
        got, want = artifacts.polytope_mesh(live), jartifacts.polytope_mesh(live)
        _vertex_sets_equal(got[0], want[0])
        assert len(got[1]) == len(want[1])
        n += 1
    assert n == 2
    # an empty polytope has no mesh
    empty = np.array([[1.0, 0, 0, -1.0], [-1.0, 0, 0, -1.0]])
    assert artifacts.polytope_mesh(empty) is None


def test_plots_write_pngs(tmp_path):
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 2, seed=9, min_seg=2)
    data = qp.build_qp(cfg, sc.state, sc.hpolys, sc.times, sc.seg,
                       device="cpu")
    sol = admm.solve_qp(data, SolverConfig())
    traj = trajectory.from_solution(sol.coeffs, torch.as_tensor(sc.times),
                                    torch.as_tensor(sc.seg))
    p1 = artifacts.plot_trajectory(traj, 0, str(tmp_path / "traj.png"))
    p2 = artifacts.plot_trajectory(traj, 0, str(tmp_path / "flat.png"),
                                   phys=PhysParams())
    polys = [sc.hpolys[0, i][np.linalg.norm(sc.hpolys[0, i, :, :3], axis=1)
                             > 0] for i in range(int(sc.seg[0]))]
    _, states = trajectory.sample(traj, 50, max_deriv=0)
    p3 = artifacts.plot_corridor_3d(polys, states[0, :, 0].numpy(), None,
                                    str(tmp_path / "corridor.png"))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 1000


def test_cli_help_and_datagen(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "allocnet_tpu_torch.cli", *a],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    out = run("--help")
    assert out.returncode == 0, out.stderr
    for cmd in ("datagen", "train", "eval", "plan", "export", "--device"):
        assert cmd in out.stdout
    path = str(tmp_path / "ds.h5")
    out = run("--device", "cpu", "--res", "10", "datagen", "--out", path,
              "--n", "4")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["out"] == path and 1 <= rec["samples"] <= 4
    back = dataset.read_h5(path, QPConfig(res=10))
    assert len(back.seg) == rec["samples"]


def test_cli_export_reads_both_checkpoint_kinds(tmp_path):
    from allocnet_tpu_torch import cli
    from allocnet_tpu_torch.models import export

    src = os.path.join(ROOT, "data", "params", "seq5_tokenthresh0_35.msgpack")
    cli.main(["--device", "cpu", "export", "--checkpoint", src, "--out",
              str(tmp_path / "a")])
    pt = str(tmp_path / "a" / "model.pt")
    cli.main(["--device", "cpu", "export", "--checkpoint", pt, "--out",
              str(tmp_path / "b")])
    a, b = export.load(pt, device="cpu"), export.load(
        str(tmp_path / "b"), device="cpu")
    x, h = torch.randn(1, 9, 2), torch.randn(1, 50, 4, 5)
    with torch.no_grad():
        for u, v in zip(a(x, h), b(x, h)):
            assert torch.equal(u, v)


def test_new_entry_points_default_to_the_card(tmp_path):
    """Without a card, the application layer's entry points that are not
    asked for the CPU raise instead of running there."""
    from allocnet_tpu_torch.config import AllocNetConfig
    from allocnet_tpu_torch.models import export
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.parallel import mesh, scaling
    from allocnet_tpu_torch.planner import driver
    from allocnet_tpu_torch.train import datagen

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = AllocNetConfig(qp=QPConfig(res=5))
    sc = scenarios.random_scenarios(cfg.qp, 2, seed=0)
    net = ConvLSTMAllocNet(5, 16, 0.42)
    calls = [
        lambda: datagen.generate(cfg, 1, points=datagen.random_pillar_map(0)),
        lambda: datagen.certified(cfg, sc),
        lambda: driver.onchip_tick_cost(net, None, cfg, sc.state[:1],
                                        sc.hpolys[:1], sc.seg[:1], n_ticks=2),
        lambda: export.save_replan(str(tmp_path), net, cfg),
        lambda: export.load(str(tmp_path)),
        lambda: scaling.solve_scaling(per_device_batch=2, cfg=cfg.qp),
        lambda: mesh.make_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
