"""Port parity, the training chain (train/refine_targets, calibrate_thresh,
train_big, finetune_qp, chain: the ports of scripts/refine_targets.py,
calibrate_thresh.py, train_big3.py, train_big4.py and finetune_qp.py) and
the JAX package's initialization (train_step.init_params).

- init_params against `net.init` of the JAX nets: per-tensor std within
  STD_RTOL for tensors of 1,000 entries or more, within SMALL_SIGMAS
  sampling deviations below that; every weight inside +-2 sigma; zero
  biases, the ConvMLP's last bias 1.0, LayerNorm scales 1; seeded; the
  JAX package's very draws for a seed (utils/jax_random: threefry bits
  and fold_in bit for bit, every weight within INIT_ULPS units in the
  last place of its truncation bound, at least INIT_EQUAL of each weight
  tensor bit-equal).
- the refinement's chunking, padding, parts, assembly, statistics, resume
  and refusal against the JAX script's own run over 40 rows at --chunk 16
  (tests/records/refine_targets_jax40.npz, tests/jax_chain_record.py):
  the solver is stubbed with the script's recorded refine_times outputs,
  so the arrays compare exactly.
- the calibration's split against the JAX Loader's, its choice against
  the script's `max` on a table with ties.
- the fine-tune's params-only start and two of its steps at B=8 against
  the JAX package's (f64, test_torch_train's tolerances).
- each module's config equal to its script's module-level cfg.
- each of chain.py's gates refusing a doctored result.
"""

import dataclasses
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.models import packing as jpacking
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTM
from allocnet_tpu.models.networks import ConvMLPAllocNet as JConvMLP
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet, ConvMLPAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, qp
from allocnet_tpu_torch.train import (calibrate_thresh, chain, corpus,
                                      dataset, finetune_qp, refine_targets,
                                      train_big)
from allocnet_tpu_torch.train import train_step as ts_lib
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFINE40 = os.path.join(ROOT, "tests", "records", "refine_targets_jax40.npz")
STD_RTOL = 0.05
SMALL_SIGMAS = 4.0
# excess kurtosis of a normal truncated at +-2 sigma: the sample std of n
# draws has a relative spread of sqrt((kurtosis - 1) / (4 n))
TRUNC_KURTOSIS = 2.3642
# init_params against the JAX package's CPU draws: XLA's float32 log1p
# and numpy's part by an ulp at most, which the inverse error function
# carries to 2 ulps of the bound 2 sigma
INIT_ULPS, INIT_EQUAL = 4, 0.95


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- init_params -----------------------------------------------------------

NETS = {"lstm": (lambda: JConvLSTM(5, 256, 0.42),
                 lambda: ConvLSTMAllocNet(5, 256, 0.42)),
        "mlp": (lambda: JConvMLP(5, 5, 128), lambda: ConvMLPAllocNet(5, 5,
                                                                     128))}


def _jax_init(jnet, seed):
    p = jnet.init(jax.random.PRNGKey(seed),
                  jpacking.pack_state(jnp.zeros((1, 2, 3, 3))),
                  jpacking.pack_hpolys(jnp.zeros((1, 5, 50, 4))))
    return {k: v.numpy() for k, v in weights.from_jax_params(
        jax.tree.map(np.asarray, p)).items()}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_init_params_matches_the_jax_distribution(kind):
    jnet, tnet = NETS[kind]
    want = _jax_init(jnet(), 0)
    got = {k: v.numpy() for k, v in ts_lib.init_params(tnet(), 0)
           .state_dict().items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.std() == 0:                 # biases, LayerNorm scales
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        n = w.size
        tol = (STD_RTOL if n >= 1000 else SMALL_SIGMAS * np.sqrt(
            2 * (TRUNC_KURTOSIS - 1) / (4 * n)))
        assert abs(g.std() / w.std() - 1) <= tol, (k, g.std(), w.std())


@pytest.mark.parametrize("kind", sorted(NETS))
def test_init_params_values(kind):
    net = ts_lib.init_params(NETS[kind][1](), 3)
    for mod in net.modules():
        for name, p in mod.named_parameters(recurse=False):
            p = p.detach()
            if isinstance(mod, torch.nn.LayerNorm):
                assert bool((p == (1.0 if name == "weight" else 0.0)).all())
            elif name.startswith("bias"):
                want = 1.0 if mod is getattr(net.output_module, "8",
                                             None) else 0.0
                assert bool((p == want).all()), name
            else:
                sigma = (np.sqrt(2.0 / p[0].numel()) / ts_lib.TRUNC_STD)
                assert float(p.abs().max()) <= 2 * sigma * (1 + 1e-6)
                assert float(p.abs().max()) > sigma


def test_init_params_is_seeded():
    a = ts_lib.init_params(ConvLSTMAllocNet(5, 32, 0.42), 7).state_dict()
    b = ts_lib.init_params(ConvLSTMAllocNet(5, 32, 0.42), 7).state_dict()
    c = ts_lib.init_params(ConvLSTMAllocNet(5, 32, 0.42), 8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["output_module.weight_ih_l0"],
                           c["output_module.weight_ih_l0"])


@jax.enable_x64(False)
def test_jax_random_is_jax():
    """As the JAX package trains: 32-bit types (this suite turns 64-bit
    types on, which draws other bits)."""
    from allocnet_tpu_torch.utils import jax_random

    key = jax.random.PRNGKey(5)
    ours = jax_random.prng_key(5)
    assert np.array_equal(np.asarray(key), np.array(ours, np.uint32))
    want = np.asarray(jax.random.fold_in(key, 123456789))
    assert np.array_equal(want, np.array(jax_random.fold_in(ours,
                                                            123456789)))
    b1, b2 = jax_random.threefry2x32(ours, np.zeros(21, np.uint32),
                                     np.arange(21, dtype=np.uint32))
    assert np.array_equal(np.asarray(jax.random.bits(key, (7, 3))),
                          (b1 ^ b2).reshape(7, 3))
    z = jax_random.truncated_normal(ours, (4096,))
    want = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, (4096,)))
    assert np.abs(z - want).max() <= INIT_ULPS * np.spacing(np.float32(2))
    assert np.mean(z == want) >= INIT_EQUAL


@pytest.mark.parametrize("kind,seed", [(k, s) for k in sorted(NETS)
                                       for s in (0, 1)])
def test_init_params_equals_the_jax_draws(kind, seed):
    jnet, tnet = NETS[kind]
    with jax.enable_x64(False):      # as the JAX package trains
        want = _jax_init(jnet(), seed)
    got = {k: v.numpy() for k, v in ts_lib.init_params(tnet(), seed)
           .state_dict().items()}
    for k, w in want.items():
        g = got[k]
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        sigma = np.sqrt(2.0 / w[0].size) / ts_lib.TRUNC_STD
        assert np.abs(g - w).max() <= INIT_ULPS * np.spacing(
            np.float32(2 * sigma)), k
        assert np.mean(g == w) >= INIT_EQUAL, k


class _CaptureTrainer:
    """A Trainer stand-in that keeps the net it was given."""
    nets = []

    def __init__(self, cfg, net, loader, workdir, device=None, **kw):
        self.nets.append((cfg, {k: v.clone() for k, v in
                                net.state_dict().items()}))
        self.step = 0
        raise SystemExit("captured")


def test_cmd_train_uses_init_params(monkeypatch, tmp_path):
    from allocnet_tpu_torch import cli
    from allocnet_tpu_torch.train import trainer

    sc = ScenarioBatch(np.zeros((4, 2, 3, 3)), np.zeros((4, 5, 50, 4)),
                       np.ones((4, 5)), np.full(4, 2, np.int32))
    data = str(tmp_path / "d.npz")
    dataset.write_npz(data, sc)
    _CaptureTrainer.nets = []
    monkeypatch.setattr(trainer, "Trainer", _CaptureTrainer)
    args = types.SimpleNamespace(res=10, batch_size=2, epochs=1, hidden=32,
                                 dataset=data, workdir=str(tmp_path / "w"),
                                 device="cpu")
    with pytest.raises(SystemExit):
        cli.cmd_train(args)
    cfg, sd = _CaptureTrainer.nets[0]
    want = ts_lib.init_params(ConvLSTMAllocNet(5, 32, 0.42),
                              cfg.train.seed).state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)


@pytest.mark.parametrize("init", ["jax", "default"])
def test_train_big_starts_from_init_params(monkeypatch, tmp_path, init):
    from allocnet_tpu_torch.train import trainer

    sc = ScenarioBatch(np.zeros((4, 2, 3, 3)), np.zeros((4, 5, 50, 4)),
                       np.ones((4, 5)), np.full(4, 2, np.int32))
    data = str(tmp_path / "d.npz")
    dataset.write_npz(data, sc)
    _CaptureTrainer.nets = []
    monkeypatch.setattr(trainer, "Trainer", _CaptureTrainer)
    with pytest.raises(SystemExit):
        train_big.train("big3", data, str(tmp_path / "w"), seed=1,
                        init=init, device="cpu", log=lambda s: None)
    cfg, sd = _CaptureTrainer.nets[0]
    assert cfg.train.seed == 1
    with open(tmp_path / "w" / "dataset.json") as f:
        assert json.load(f)["n"] == 4
    want = ts_lib.init_params(ConvLSTMAllocNet(5, 256, 0.42), 1).state_dict()
    same = all(torch.equal(sd[k], want[k]) for k in want)
    assert same == (init == "jax")


# ---- configs ---------------------------------------------------------------

@pytest.mark.parametrize("name,port", [
    ("refine_targets", refine_targets.CFG),
    ("calibrate_thresh", calibrate_thresh.CFG),
    ("train_big3", train_big.CFG), ("train_big4", train_big.CFG),
    ("finetune_qp", finetune_qp.CFG)])
def test_config_is_the_scripts(name, port):
    mod = _script(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(mod.cfg)
    if name == "refine_targets":
        assert (refine_targets.CHUNK, refine_targets.STEPS) == (mod.CHUNK,
                                                                mod.STEPS)
    if name == "calibrate_thresh":
        assert calibrate_thresh.GRID == mod.GRID


# ---- the refinement against the JAX script's run ---------------------------

@pytest.fixture(scope="module")
def rec40():
    z = np.load(REFINE40)
    return {k: z[k] for k in z.files}


def _stub_refine(rec, monkeypatch, calls):
    """refine_rows answered from the script's recorded refine_times calls
    (in order); each call's padded inputs must equal the recorded ones."""
    def refine_rows(sc, ip, steps=6, device=None, cfg=None):
        c = len(calls)
        calls.append(np.asarray(ip))
        np.testing.assert_array_equal(sc.times[ip], rec[f"call{c}_times_in"])
        out = {k: rec[f"call{c}_{k}"] for k in ("times", "improved",
                                                "obj0", "obj")}
        out["rel"] = refine_targets.rel_of(out["obj0"], out["obj"])
        return out
    monkeypatch.setattr(refine_targets, "refine_rows", refine_rows)


def _rows40(tmp_path):
    from allocnet_tpu_torch.train import heldout_eval
    src = str(tmp_path / "in.npz")
    dataset.write_npz(src, heldout_eval.load_scenarios(40))
    return src


def test_refine_assembly_matches_the_jax_script(rec40, tmp_path,
                                                monkeypatch):
    src, out = _rows40(tmp_path), str(tmp_path / "out.npz")
    calls = []
    _stub_refine(rec40, monkeypatch, calls)
    r = refine_targets.refine_corpus(src, out, int(rec40["chunk"]),
                                     device="cpu", log=lambda s: None)
    assert len(calls) == int(rec40["calls"]) == 3
    # the tail chunk padded with its last row
    np.testing.assert_array_equal(calls[-1], list(range(32, 40)) + [39] * 8)
    got = np.load(out)
    for k in ("state", "hpolys", "times", "seg"):
        assert got[k].dtype == rec40[f"out_{k}"].dtype, k
        assert got[k].tobytes() == rec40[f"out_{k}"].tobytes(), k
    with open(refine_targets.stats_path(out)) as f:
        assert json.load(f) == json.loads(str(rec40["stats"]))
    assert r["stats"] == json.loads(str(rec40["stats"]))
    for c in range(3):
        part = np.load(refine_targets.part_path(out, c))
        for k in ("times", "improved", "rel", "start", "stop", "steps",
                  "n_total"):
            np.testing.assert_array_equal(part[k], rec40[f"part{c}_{k}"])


def test_refine_resume_and_refusal(rec40, tmp_path, monkeypatch):
    src, out = _rows40(tmp_path), str(tmp_path / "out.npz")
    _stub_refine(rec40, monkeypatch, [])
    refine_targets.refine_corpus(src, out, 16, device="cpu",
                                 log=lambda s: None)
    first = {k: v for k, v in np.load(out).items()}
    # an existing output: nothing to do
    assert refine_targets.refine_corpus(src, out, 16, device="cpu",
                                        log=lambda s: None) == {
        "skipped": out}
    os.remove(out)

    def no_solve(*a, **k):
        raise AssertionError("a resumed chunk was computed again")
    monkeypatch.setattr(refine_targets, "refine_rows", no_solve)
    r = refine_targets.refine_corpus(src, out, 16, device="cpu",
                                     log=lambda s: None)
    assert (r["computed"], r["resumed"]) == (0, 3)
    assert all(np.load(out)[k].tobytes() == v.tobytes()
               for k, v in first.items())
    os.remove(out)
    with pytest.raises(SystemExit, match="stale/incompatible"):
        refine_targets.refine_corpus(src, out, 8, device="cpu",
                                     log=lambda s: None)
    with pytest.raises(SystemExit, match="steps"):
        refine_targets.refine_corpus(src, out, 16, steps=5, device="cpu",
                                     log=lambda s: None)
    # a part without metadata (the script's legacy parts) is refused
    p = refine_targets.part_path(out, 1)
    z = {k: v for k, v in np.load(p).items() if k not in ("start", "stop")}
    np.savez(p, **z)
    with pytest.raises(SystemExit, match="missing"):
        refine_targets.refine_corpus(src, out, 16, device="cpu",
                                     log=lambda s: None)


def test_refine_chunk_launches():
    # 8 solves (the start, the raw input, 6 steps) of 4 chunks; 6 polish
    # rounds x 2 factorizations x 4 blocks of 64 columns
    assert refine_targets.chunk_launches() == (32, 384)


# ---- calibration -----------------------------------------------------------

def test_calibration_split_is_the_jax_loaders():
    from allocnet_tpu.train import dataset as jds

    rng = np.random.default_rng(5)
    n = 2600
    sc = ScenarioBatch(rng.normal(size=(n, 2, 3, 3)), np.zeros((n, 5, 1, 4)),
                       np.ones((n, 5)), np.full(n, 3, np.int32))
    want = jds.Loader(sc, batch_size=128, seed=0).val_idx[:2000]
    np.testing.assert_array_equal(calibrate_thresh.val_rows(sc, 2000), want)
    assert len(calibrate_thresh.val_rows(sc, 2000)) == 260


def test_calibration_choice_is_the_scripts_on_ties():
    rows = [{"token_thresh": t, "stop_token_accuracy": a, "success_rate": s}
            for t, a, s in ((0.25, 0.97, 0.90), (0.30, 0.98, 0.89),
                            (0.35, 0.98, 0.91), (0.42, 0.98, 0.91),
                            (0.50, 0.975, 0.95), (0.60, 0.98, 0.905))]
    want = max(rows, key=lambda r: (r["stop_token_accuracy"],
                                    r["success_rate"]))
    assert calibrate_thresh.best_row(rows) is want
    assert calibrate_thresh.best_row(rows)["token_thresh"] == 0.35
    assert admm.solve_launches(calibrate_thresh.CFG.qp,
                               calibrate_thresh.CFG.solver) == (3, 16)


# ---- the fine-tune ---------------------------------------------------------

def test_finetune_starts_from_big3_params_only(tmp_path):
    from allocnet_tpu_torch.train import trainer

    sc = corpus.concat([])
    loader = dataset.Loader(sc, batch_size=8, seed=0)
    net = ts_lib.init_params(ConvLSTMAllocNet(5, 256, 0.42), 0)
    tr = trainer.Trainer(finetune_qp.CFG, net, loader, str(tmp_path),
                         device="cpu")
    src = finetune_qp.start_params(tr, finetune_qp.START, lambda s: None)
    assert src.endswith("checkpoint24605.msgpack")
    want = weights.load_params(src)
    assert all(torch.equal(tr.net.state_dict()[k], want[k]) for k in want)
    # a fresh Adam and schedule at the fine-tune's rate
    assert tr.opt.state_dict()["state"] == {}
    assert tr.lr_sched.last_epoch == 0
    assert tr.opt.param_groups[0]["lr"] == finetune_qp.CFG.train.\
        learning_rate
    # a workdir with its own checkpoint resumes instead
    tr.step = 5
    assert finetune_qp.start_params(tr, finetune_qp.START,
                                    lambda s: None) is None


def test_finetune_two_steps_match_jax():
    """The script's path (init_state, the big3 checkpoint's params, a
    fresh Adam) against the port's (init_params, the same params through
    start_params' loader, a fresh Adam), two steps at B=8 in f64: losses
    within 1e-9, weights within 1e-6 (test_torch_train's tolerances)."""
    from allocnet_tpu.train import train_step as jts
    from allocnet_tpu.train import trainer as jtrainer

    script = _script("finetune_qp")
    jcfg = script.cfg
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(finetune_qp.CFG)
    sc = np.load(os.path.join(ROOT, "data", "eval_fresh.npz"))
    batch = [sc[k][:8].astype(np.float64) for k in ("state", "hpolys")] + [
        sc["seg"][:8], sc["times"][:8].astype(np.float64)]
    jnet = JConvLSTM(5, 256, 0.42)
    ts = jts.init_state(jnet, jcfg.train, jnp.asarray(batch[0][:1]),
                        jnp.asarray(batch[1][:1]))
    restored, _ = jtrainer.restore_checkpoint(
        os.path.join(ROOT, "runs", "big3", "checkpoints",
                     "checkpoint24605.msgpack"), ts)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          restored.params)
    ts = jts.TrainState(params, jts.make_optimizer(jcfg.train).init(params),
                        ts.step)
    net = ConvLSTMAllocNet(5, 256, 0.42)
    net.load_state_dict(calibrate_thresh.read_params(calibrate_thresh.latest(
        finetune_qp.START))[0])
    net = net.double()
    cfg = finetune_qp.CFG
    opt, sched = ts_lib.make_optimizer(net, cfg.train)
    c = jcfg
    jstep = jax.jit(lambda s, st, hp, sg, rt: jts.train_step(
        s, jnet, c.train, c.qp, c.solver, c.loss, st, hp, sg, rt,
        token_thresh=c.model.token_thresh))
    for _ in range(2):
        b = ts_lib.train_step(net, opt, sched, cfg.qp, cfg.solver, cfg.loss,
                              *(torch.tensor(a) for a in batch),
                              token_thresh=cfg.model.token_thresh)
        ts, jb = jstep(ts, *(jnp.asarray(a) for a in batch))
        for name in ("total", "obj1", "objt", "objc", "stop",
                     "success_rate"):
            g, w = float(getattr(b, name)), float(getattr(jb, name))
            assert abs(g - w) <= 1e-9 * max(1.0, abs(w)), name
        want = weights.from_jax_params(jax.tree.map(np.asarray, ts.params))
        for k, v in net.state_dict().items():
            w = want[k].double().numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-6 * max(
                1.0, float(np.abs(w).max())), err_msg=k)


# ---- the chain's gates refuse doctored results -----------------------------

def _records():
    return chain.read_records()


def _steps(n, **fields):
    return [dict(step=i + 1, epoch=0, **fields) for i in range(n)]


def _win_steps(rec, scale=1.0, acc_shift=0.0, n=180):
    """Steps whose windows equal the big3 record's (losses scaled)."""
    out = []
    for i in range(n):
        s = i + 1
        w = ("1-10" if s <= 10 else "11-90" if s <= 90 else "91-180")
        r = rec["windows"]["big3"][w]
        out.append({"step": s, "epoch": 0, "obj": r["obj"] * scale,
                    "stop": r["stop"] * scale,
                    "time_segment_accuracy": r["time_segment_accuracy"]
                    + acc_shift})
    return out


def _ft_steps(rec, scale=1.0, acc_shift=0.0):
    out = []
    for i in range(90):
        s = i + 1
        r = rec["windows"]["finetune"]["1-10" if s <= 10 else "11-90"]
        out.append({"step": s, "epoch": 0, "obj": r["obj"] * scale,
                    "success_rate": r["success_rate"],
                    "time_segment_accuracy": r["time_segment_accuracy"]
                    + acc_shift})
    return out


def _contract_case(doctor):
    rng = np.random.default_rng(0)
    n, S = 6, 5
    seg = np.array([1, 2, 3, 4, 5, 2])
    times = rng.uniform(1, 3, (n, S)).astype(np.float32)
    times[np.arange(S)[None] >= seg[:, None]] = 0.0
    src = ScenarioBatch(np.zeros((n, 2, 3, 3)), np.zeros((n, S, 1, 4)),
                        times, seg)
    imp = np.array([1, 1, 0, 1, 0, 0], bool)
    out = times.copy()
    for i in np.nonzero(imp)[0]:       # shift time between live slots
        if seg[i] > 1:
            out[i, 0] += 0.25
            out[i, 1] -= 0.25
    obj0 = np.full(n, 1.0, np.float32)
    obj = np.where(imp, 0.9, 1.0).astype(np.float32)
    if doctor == "unimproved":
        out[2, 0] += 1e-3
    elif doctor == "padding":
        out[0, 4] = 1.0
    elif doctor == "total":
        out[1, 0] += 0.01
    elif doctor == "objective":
        obj[3] = 1.0
    return src, out, imp, obj0, obj


@pytest.mark.parametrize("doctor", ["none", "unimproved", "padding",
                                    "total", "objective"])
def test_contract_gate(doctor):
    checks = {}
    chain.contract_gate(checks, *_contract_case(doctor))
    assert checks["refine_contract"]["ok"] == (doctor == "none")


GATE_CASES = ["resume_computed", "resume_bytes", "resume_not_refused",
              "reference_unwitnessed", "reference_control",
              "reference_rel", "reference_stats", "calibration_grid",
              "calibration_touch", "calibration_maps",
              "calibration_maps_missing",
              "scratch_band_low", "scratch_acc", "scratch_nonfinite",
              "finetune_window", "finetune_accuracy", "finetune_eval",
              "finetune_maps", "launches", "prefix_f64", "prefix_repeat",
              "prefix_launches", "prefix_maps_missing"]


def _doctored(case, rec):
    checks = {}
    if case.startswith("resume"):
        chain.resume_gate(checks, 1 if case == "resume_computed" else 0,
                          case != "resume_bytes",
                          case != "resume_not_refused")
        chain.resume_gate(ok := {}, 0, True, True)
        return checks, ok
    if case.startswith("reference"):
        n = 100
        rel = np.where(np.arange(n) < 60, np.linspace(0.05, 0.5, n),
                       0.0).astype(np.float32)
        ref = {"improved": np.arange(n) < 60, "rel": rel}
        ours = {"improved": np.arange(n) < 61, "rel": rel.copy()}
        wit = {"unwitnessed": [], "control": [0, 20]}
        chain.reference_gate(ok := {}, ours, ref, wit)
        if case == "reference_unwitnessed":
            wit = dict(wit, unwitnessed=[60])
        elif case == "reference_control":
            wit = dict(wit, control=[8, 20])
        elif case == "reference_rel":
            r = rel.copy()
            r[:13] += 0.002             # 13 of 60 beyond 1e-3: 0.78 within
            ours = dict(ours, rel=r)
        else:                           # the rows neither improves
            r = rel.copy()
            r[61:] = 0.2
            ours = dict(ours, rel=r)
        chain.reference_gate(checks, ours, ref, wit)
        return checks, ok
    if case.startswith("calibration"):
        grid = [dict(r) for r in rec["calibration"]["big3"]["grid"]]
        flags = np.array([1, 0, 1], bool)
        chain.calibration_gate(ok := {}, "big3", grid, grid, flags, flags)
        if case == "calibration_grid":
            grid[2]["stop_token_accuracy"] -= 0.06
            chain.calibration_gate(checks, "big3", grid,
                                   rec["calibration"]["big3"]["grid"],
                                   flags, flags)
        elif case.startswith("calibration_maps"):
            mrec = chain.read_maps_record()["calibration"]["big3"]["grid"]
            mgrid = [dict(r) for r in mrec]
            chain.maps_calibration_gate(ok, "big3_maps", mgrid, mrec)
            if case == "calibration_maps":
                mgrid[4]["success_rate"] += 0.051
            else:
                mgrid = mgrid[:-1]
            chain.maps_calibration_gate(checks, "big3", mgrid, mrec)
        else:
            chain.calibration_gate(checks, "big3", grid, grid, flags,
                                   ~flags)
        return checks, ok
    if case.startswith("scratch"):
        chain.scratch_gate(ok := {}, "x", _win_steps(rec), rec["windows"])
        steps = (_win_steps(rec, scale=0.7) if case == "scratch_band_low"
                 else _win_steps(rec, acc_shift=0.1)
                 if case == "scratch_acc" else _win_steps(rec))
        if case == "scratch_nonfinite":
            steps[50]["obj"] = float("nan")
        chain.scratch_gate(checks, "x", steps, rec["windows"])
        return checks, ok
    if case.startswith("finetune"):
        chain.finetune_gate(ok := {}, _ft_steps(rec), rec["windows"][
            "finetune"], 0.89, 0.885)
        steps = (_ft_steps(rec, scale=1.12) if case == "finetune_window"
                 else _ft_steps(rec, acc_shift=-0.04)
                 if case == "finetune_accuracy" else _ft_steps(rec))
        if case == "finetune_maps":
            mrec = chain.read_maps_record()["finetune"]
            steps = [dict(s) for s in mrec["steps"]]
            chain.finetune_maps_gate(ok, steps, mrec)
            for s in steps:
                s["success_rate"] -= 0.031
            chain.finetune_maps_gate(checks, steps, mrec)
            return checks, ok
        chain.finetune_gate(checks, steps, rec["windows"]["finetune"],
                            0.86 if case == "finetune_eval" else 0.89,
                            0.885)
        return checks, ok
    if case == "launches":
        chain.launch_gate(ok := {}, "x", (64, 128), (64, 128))
        chain.launch_gate(checks, "x", (64, 124), (64, 128))
        return checks, ok
    if case == "prefix_maps_missing":
        # maps up to 999: none of the record's to gate; up to 1031: all
        # three, none of which the prefix generated at the record's request
        mrec = chain.read_maps_record()
        chain.maps_gates(ok := {}, [{"map": 999, "request": 250}], [{}],
                         mrec, "cpu", lambda s: None)
        chain.maps_gates(checks, [{"map": m, "request": 100} for m in (
            1000, 1030, 1031)], [{}] * 3, mrec, "cpu", lambda s: None)
        return checks, ok
    entries = [{"map": 1000, "k1": 4, "l1": 48, "to_certify": 300}]
    good = {1000: {"rows": 32, "failing": [], "repeat_equal": True}}
    chain.prefix_gates(ok := {}, entries, good, True)
    if case == "prefix_f64":
        chain.prefix_gates(checks, entries, {1000: dict(
            good[1000], failing=[7])}, True)
    elif case == "prefix_repeat":
        chain.prefix_gates(checks, entries, {1000: dict(
            good[1000], repeat_equal=False)}, True)
    else:
        chain.prefix_gates(checks, [dict(entries[0], l1=47)], good, True)
    return checks, ok


@pytest.mark.parametrize("case", GATE_CASES)
def test_chain_gate_refuses_a_doctored_result(case):
    checks, ok = _doctored(case, _records())
    assert ok and all(v["ok"] for v in ok.values()), ok
    assert checks and not all(v["ok"] for v in checks.values()), checks


def test_windows_and_train_launches():
    steps = _steps(180, obj=2.0, stop=1.0)
    w = chain.windows(steps)
    assert sorted(w) == ["1-10", "11-90", "91-180"]
    assert chain.windows(steps[:100]).keys() == {"1-10", "11-90"}
    r = {"train": {"steps": 180, "val_batches": 20},
         "eval": {"batches": 8}}
    assert chain.train_launches(r) == ((400, 800), (24, 128))


def test_reference_gate_passes_only_the_listed_rows():
    n = 300
    rel = np.where(np.arange(n) < 200, 0.3, 0.0).astype(np.float32)
    ref = {"improved": np.arange(n) < 200, "rel": rel}
    ours = {"improved": (np.arange(n) < 200) | (np.arange(n) == 202),
            "rel": rel}
    for rows, want in (([202], True), ([201], False), ([202, 201], False)):
        checks = {}
        chain.reference_gate(checks, ours, ref, {"unwitnessed": rows,
                                                 "control": [0, 20]})
        got = checks["refine_reference"]
        assert got["ok"] == want, rows
        assert sorted(got["explained"]) == [i for i in rows if i == 202]


def _row202_inputs(idx):
    sc = refine_targets.read_corpus(os.path.join(ROOT, "data",
                                                 "eval_fresh.npz"))
    cfg = refine_targets.CFG
    t = lambda a: torch.as_tensor(a[idx])
    data = qp.build_qp(cfg.qp, t(sc.state), t(sc.hpolys), t(sc.times),
                       torch.as_tensor(sc.seg[idx]).long(), device="cpu")
    return cfg, data


@pytest.mark.parametrize("threads", [1, 4])
def test_plain_chunk_reads_no_batch_mate(threads):
    """eval_fresh row 202 through the plain ADMM chunk (the refinement's
    cfg, its stored times; its chunk inputs built once in a batch of 64
    and sliced): its outputs after 20 iterations are bit-equal alone, with
    itself, with row 5 and in the batch of 64, under one torch thread and
    under four.  The chunk's matrix-vector products (the f64 Kx product
    among them) are elementwise products and sums, whose summation order
    does not depend on the batch size."""
    cfg, data = _row202_inputs(np.array([202, 5] + list(range(62))))
    s = cfg.solver
    args = admm_chunk.chunk_inputs(data, s)
    pick = lambda rows: [a[rows] if torch.is_tensor(a) and a.dim()
                         and a.shape[0] == 64 else a for a in args]
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        runs = [admm_chunk.admm_chunk_reference(
            *pick(torch.as_tensor(rows)), 20, s.sigma, s.alpha)
            for rows in ([0], [0, 0], [0, 1], list(range(64)))]
    finally:
        torch.set_num_threads(n)
    for got in runs[1:]:
        for g, w in zip(got, runs[0]):
            assert torch.equal(g[0], w[0])


def test_row202_admm_reads_no_batch_mate():
    """The same row's whole ADMM (admm_solve_chunked, the refinement's
    cfg: every chunk, the rho rescales between them) alone, beside row 5
    and beside itself, each built at its own batch size: its iterate and
    residuals are bit-equal.  (The polish after it still takes batched
    products, which part at B = 1 and B = 2 for this row.)"""
    outs = []
    for idx in ([202], [202, 5], [202, 202]):
        cfg, data = _row202_inputs(np.array(idx))
        x, z, y, _, _, pri, dua = admm_chunk.admm_solve_chunked(data,
                                                                cfg.solver)
        outs.append((x[0], pri[0], dua[0]))
    for got in outs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(got, outs[0]))
