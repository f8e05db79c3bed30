"""Port parity, the driver's fast start and on-chip tick cost:
planner/driver (enable_compilation_cache, Driver(cache_dir=, aot_path=),
save_aot, _load_aot, onchip_tick_cost) on the CPU, the tick cost against
allocnet_tpu's.

The CPU has no nvcc, so the saved artefact holds the native runtime only
(the manifest's kernel entry is null).  Tolerances: the first tick of a
driver that took the prebuilt libraries equals one that built them
(bitwise: same code, same inputs); the chained ticks' flags equal a
step-by-step replay of the same tick functions (bitwise), and the solved
and arrived fractions equal the JAX package's `onchip_tick_cost` on the
same mission (tests/test_driver.py's first corridor)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import CorridorConfig as JCorridorConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.planner import driver as jdriver
from allocnet_tpu.planner import planner as jplanner
from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       QPConfig, SolverConfig)
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.planner import driver, native
from tests.test_driver import ConstTimeNet as JConstTimeNet
from tests.test_driver import _pillar_map
from tests.test_torch_driver import ConstTimeNet
from tests.torch_threads import one_torch_thread  # noqa: F401

BUDGET = dict(n_chunks=4, polish_rounds=6, iters_per_chunk=250)
START = np.array([2.0, 3.0, 2.0])
GOAL1 = np.array([18.0, 3.0, 2.0])
N_TICKS = 10


def _cfg(res=10):
    return AllocNetConfig(qp=QPConfig(res=res), solver=SolverConfig(**BUDGET),
                          corridor=CorridorConfig(use_rrt_star=False))


@pytest.fixture
def build_dirs(tmp_path):
    """Restores the libraries' build directories after the test (the
    fast start points them elsewhere)."""
    mods = (admm_chunk, ldl, native)
    dirs = [mod.BUILD_DIR for mod in mods]
    yield tmp_path
    for mod, d in zip(mods, dirs):
        mod.set_build_dir(d)


def _net(seed=0):
    torch.manual_seed(seed)
    return ConvLSTMAllocNet(5, 16, token_thresh=0.42)


def test_save_aot_and_load_roundtrip(build_dirs, monkeypatch):
    aot, cache = str(build_dirs / "aot"), str(build_dirs / "cache")
    net, cfg = _net(), _cfg()
    drv = driver.Driver(net, None, cfg, device="cpu")
    assert not drv.aot_loaded
    sizes = drv.save_aot(aot)
    manifest = json.load(open(os.path.join(aot, "manifest.json")))
    assert manifest["kernel"] is None and manifest["ldl"] is None
    assert manifest["device"] == "cpu"
    assert set(sizes) == {"native"} and sizes["native"] > 10_000
    assert os.path.exists(os.path.join(aot, manifest["native"]))
    assert manifest["cfg"] == repr(drv.cfg_tick)

    # a fresh driver, an empty build directory and no compiler: it takes
    # the prebuilt runtime
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    drv2 = driver.Driver(net, None, cfg, device="cpu", cache_dir=cache,
                         aot_path=aot)
    assert drv2.aot_loaded
    assert os.listdir(cache) == [manifest["native"]]
    assert native.build() == os.path.join(cache, manifest["native"])
    assert native.available()

    args = driver._aot_dummy_args(cfg, device="cpu")
    out1, out2 = drv._cold(*args), drv2._cold(*args)
    for a, b in zip(out1[:3], out2[:3]):
        assert torch.equal(a, b)
    assert torch.equal(out1[3].state9, out2[3].state9)


def test_a_changed_config_or_params_is_not_loaded(build_dirs):
    aot = str(build_dirs / "aot")
    net, cfg = _net(), _cfg()
    driver.Driver(net, None, cfg, device="cpu").save_aot(aot)
    assert driver.Driver(net, None, cfg, device="cpu", aot_path=aot).aot_loaded
    other_cfg = driver.Driver(net, None, _cfg(res=12), device="cpu",
                              aot_path=aot)
    assert not other_cfg.aot_loaded
    other_net = driver.Driver(_net(seed=1), None, cfg, device="cpu",
                              aot_path=aot)
    assert not other_net.aot_loaded
    params = {k: v + 1e-3 for k, v in net.state_dict().items()}
    assert not driver.Driver(net, params, cfg, device="cpu",
                             aot_path=aot).aot_loaded
    assert not driver.Driver(net, None, cfg, device="cpu",
                             aot_path=str(build_dirs / "absent")).aot_loaded
    # a matching manifest whose library is gone is an error, not a miss
    manifest = json.load(open(os.path.join(aot, "manifest.json")))
    os.remove(os.path.join(aot, manifest["native"]))
    with pytest.raises(FileNotFoundError):
        driver.Driver(net, None, cfg, device="cpu",
                      cache_dir=str(build_dirs / "cache2"), aot_path=aot)


@pytest.fixture(scope="module")
def mission():
    """tests/test_driver.py's first corridor (the JAX front end), as the
    B=1 cold-tick inputs (state9, hpolys, seg)."""
    pm = jplanner.build_map(_pillar_map(), [0, 0, 0], [20, 20, 4],
                            scale=0.25, dilate_r=2)
    jcfg = JAllocNetConfig(qp=JQPConfig(res=10),
                           solver=JSolverConfig(**BUDGET),
                           corridor=JCorridorConfig(use_rrt_star=False))
    cp = jplanner.plan_corridor(pm, START, GOAL1, jcfg, seed=3)
    state9 = np.zeros((1, 2, 3, 3), np.float32)
    state9[0, 0, :, 0] = START
    state9[0, 1, :, 0] = cp.route[-1]
    return (state9, np.asarray(cp.hpolys, np.float32)[None],
            np.array([cp.seg])), jcfg


def test_chained_ticks_match_step_by_step(mission):
    (state9, hp, seg), _ = mission
    cfg = _cfg()
    net = ConstTimeNet(5.0, 5)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)
    flags, done = driver._chain_ticks(net, cfg, t(state9), t(hp),
                                      t(seg, torch.long), N_TICKS, 0.1, 1.0,
                                      0)
    # the replay: a host loop over the same tick functions that stops
    # calling them once the vehicle has arrived
    with torch.no_grad():
        s0, _, _, adv = driver._cold_tick(net, cfg, 0.1, 1.0, t(state9),
                                          t(hp), t(seg, torch.long))
        want = [bool(s0[0])]
        arrived = bool(adv.done[0])
        for _ in range(N_TICKS - 1):
            if arrived:
                want.append(True)
                continue
            s, _, _, adv = driver._warm_tick(cfg, 0.1, 0, False, adv.state9,
                                             adv.hpolys, adv.seg, adv.prev)
            want.append(bool(s[0]))
            arrived = bool(adv.done[0])
    assert flags[:, 0].tolist() == want
    assert bool(done[0]) == arrived
    assert sum(want) >= N_TICKS - 1


def test_onchip_tick_cost_matches_jax(mission):
    (state9, hp, seg), jcfg = mission
    per, solved, arrived = driver.onchip_tick_cost(
        ConstTimeNet(5.0, 5), None, _cfg(), state9, hp, seg,
        n_ticks=N_TICKS, device="cpu")
    jper, jsolved, jarrived = jdriver.onchip_tick_cost(
        JConstTimeNet(), {"t": jnp.asarray(5.0), "S": 5}, jcfg,
        jnp.asarray(state9), jnp.asarray(hp), jnp.asarray(seg, jnp.int32),
        n_ticks=N_TICKS)
    assert per > 0 and np.isfinite(per)
    assert solved == pytest.approx(jsolved, abs=1e-9)
    assert arrived == pytest.approx(jarrived, abs=1e-9)
