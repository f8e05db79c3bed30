"""Port parity, the ablation (train/ablation.py: the port of
scripts/train_big2.py, scripts/train_ablation.py and scripts/mlp_probe.py).

- each arm's cfg and loss equal to its script's, its net's parameters
  (names and shapes) to the JAX net the script builds;
- the committed 40-step CPU runs from the JAX init on eval_fresh batches
  (tests/jax_ablation_record.py): the port's two seeds within the JAX
  seeds' span of each window, widened to the JAX seeds' own spread or
  BAND_LOSS / BAND_RATE, whichever is wider;
- each of the module's gates refusing a doctored result, the launch
  counts per step and eval batch, the flag records and McNemar;
- the module's run on the CPU on a prepared corpus of held-out rows: the
  arms' files and the family's verdict.
(Two Adam steps at each arm's loss weights against the JAX package's are
cases of tests/test_torch_train.py::test_two_adam_steps_match_jax.)
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from allocnet_tpu.models import packing as jpacking
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTM
from allocnet_tpu.models.networks import ConvMLPAllocNet as JConvMLP
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.train import ablation, chain, dataset, heldout_eval
from tests.jax_ablation_record import jax_cfg, port_cfg, script
from tests.torch_threads import one_torch_thread  # noqa: F401

# the port's CPU window means against the JAX package's: within the JAX
# seeds' span widened by the larger of this and the JAX seeds' own spread
# (relative for a loss, absolute for a rate); the port's values take no
# part in the width
BAND_LOSS, BAND_RATE = 0.25, 0.08


# ---- cfg, loss and net -----------------------------------------------------

@pytest.mark.parametrize("arm", list(ablation.ARMS))
def test_arm_is_the_scripts(arm):
    jcfg = jax_cfg(arm)
    cfg = ablation.arm_cfg(arm)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_cfg(jcfg))
    if arm.startswith("mlp"):
        want = script("mlp_probe").ARMS[arm[len("mlp_"):]]
        assert dataclasses.asdict(cfg.loss) == dataclasses.asdict(want)
        jnet = JConvMLP(seg=jcfg.qp.max_seg, seq_len=jcfg.model.seq_len,
                        hidden_size=jcfg.model.hidden_size)
    else:
        jnet = JConvLSTM(seq_len=jcfg.model.seq_len,
                         hidden_size=jcfg.model.hidden_size,
                         token_thresh=jcfg.model.token_thresh)
    p = jnet.init(jax.random.PRNGKey(0),
                  jpacking.pack_state(jnp.zeros((1, 2, 3, 3))),
                  jpacking.pack_hpolys(jnp.zeros((1, 5, 50, 4))))
    want = weights.from_jax_params(jax.tree.map(np.asarray, p))
    got = ablation.net_factory(arm)(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert cfg.model.hidden_size == 256
    assert (cfg.train.max_epochs, cfg.train.t0, cfg.train.t_mult) == (
        ablation.ARMS[arm]["epochs"], 3000, 2)


def test_lstm_schedule_ends_at_the_second_restart():
    """The LSTM arms' 50 epochs of 180 steps (the prefix's 0.9 split at
    B=128) end at update 9,000, the end of the second cosine period, where
    the TPU runs' learning rate at 8,901-9,000 is the same."""
    steps = int(ablation.LSTM_ROWS * 0.9) // 128 * 50
    assert steps == 9000
    cfg = ablation.arm_cfg("lstm_qp_grad").train
    assert cfg.t0 + cfg.t0 * cfg.t_mult == steps
    assert int(ablation.MLP_ROWS * 0.9) // 128 * 15 == 1050


# ---- the committed CPU runs ------------------------------------------------

def _cpu():
    return (ablation.read_json(ablation.JAX_CPU),
            ablation.read_json(ablation.PORT_CPU))


@pytest.mark.parametrize("arm", list(ablation.ARMS))
def test_port_cpu_runs_agree_with_jax(arm):
    jrec, prec = _cpu()
    jr, pr = jrec["curves"][arm], prec["curves"][arm]
    assert sorted(jr) == ["jax_0", "jax_1"]
    assert sorted(pr) == ["port_0", "port_1"]
    for runs in (jr, pr):
        for r in runs.values():
            assert len(r["steps"]) == ablation.CPU_STEPS
            assert all(np.isfinite(s[k]) for s in r["steps"] for k in s)
    for w in ("1-10", f"11-{ablation.CPU_STEPS}"):
        for k in ablation.LOSSES + ablation.RATES:
            jv = [r["windows"][w][k] for r in jr.values()]
            pv = [r["windows"][w][k] for r in pr.values()]
            loss = k in ablation.LOSSES
            spread = ((max(jv) - min(jv)) / max(abs(np.mean(jv)), 1e-12)
                      if loss else max(jv) - min(jv))
            lo, hi = chain.band(jv, loss, max(
                BAND_LOSS if loss else BAND_RATE, spread))
            assert all(lo <= v <= hi for v in pv), (w, k, pv, lo, hi)


def test_spread_feeds_the_bands():
    jrec, prec = _cpu()
    sp = ablation.spread(jrec, prec, "lstm_qp_grad")
    assert sorted(sp) == sorted(f"{a}-{b}" for a, b in
                                ablation.WINDOWS["lstm"])
    assert sp["2901-3000"] == sp["11-90"]
    runs = {**jrec["curves"]["lstm_qp_grad"],
            **prec["curves"]["lstm_qp_grad"]}
    v = [r["windows"]["1-10"]["obj"] for r in runs.values()]
    assert sp["1-10"]["obj"] == pytest.approx((max(v) - min(v))
                                              / np.mean(v))


# ---- the gates refuse doctored results -------------------------------------

def _steps_at(rec, arm, scale=1.0, shift=0.0, n=None):
    """Steps whose windows equal the arm's record's (losses scaled,
    rates shifted)."""
    wins = ablation.WINDOWS[ablation.ARMS[arm]["family"]]
    n = n or wins[-1][1]
    out = []
    for s in range(1, n + 1):
        w = next((f"{a}-{b}" for a, b in wins if a <= s <= b), None)
        r = rec["windows"][arm][w] if w else rec["windows"][arm]["1-10"]
        out.append({"epoch": 0, "step": s,
                    **{k: r[k] * scale for k in ablation.LOSSES},
                    **{k: r[k] + shift for k in ablation.RATES}})
    return out


GATE_CASES = ["loss_high", "rate_low", "nonfinite", "no_window",
              "eval_mlp", "launches"]


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_refuses_a_doctored_result(case):
    rec = ablation.read_json(ablation.RECORDS)
    checks, ok = {}, {}
    arm = "mlp_qp_grad"
    if case in ("loss_high", "rate_low", "nonfinite", "no_window"):
        ablation.window_gate(ok, arm, _steps_at(rec, arm), rec["windows"][
            arm], {})
        steps = (_steps_at(rec, arm, scale=1.3) if case == "loss_high"
                 else _steps_at(rec, arm, shift=-0.09)
                 if case == "rate_low" else _steps_at(rec, arm, n=9)
                 if case == "no_window" else _steps_at(rec, arm))
        if case == "nonfinite":
            steps[500]["obj"] = float("nan")
        ablation.window_gate(checks, arm, steps, rec["windows"][arm], {})
    elif case == "eval_mlp":
        ev = rec["eval_fresh"][arm]
        ablation.eval_gate(ok, arm, dict(ev, success_rate=ev[
            "success_rate"] - 0.039), ev)
        ablation.eval_gate(checks, arm, dict(ev, success_rate=ev[
            "success_rate"] - 0.041), ev)
        # an LSTM arm's eval (cut corpus) is not gated
        ablation.eval_gate(none := {}, "lstm_qp_grad", dict(
            ev, success_rate=0.0), rec["eval_fresh"]["lstm_qp_grad"])
        assert none == {}
    else:
        chain.launch_gate(ok, "x", (2, 4), (2, 4))
        chain.launch_gate(checks, "x", (2, 3), (2, 4))
    assert ok and all(v["ok"] for v in ok.values()), ok
    assert checks and not all(v["ok"] for v in checks.values()), checks


def test_window_gate_widens_to_the_spread():
    rec = ablation.read_json(ablation.RECORDS)
    arm = "lstm_supervised"
    steps = _steps_at(rec, arm, scale=1.3)
    ablation.window_gate(narrow := {}, arm, steps, rec["windows"][arm], {})
    widen = {w: {k: 0.35 for k in ablation.LOSSES} for w in
             rec["windows"][arm]}
    ablation.window_gate(wide := {}, arm, steps, rec["windows"][arm], widen)
    assert not narrow[f"windows_{arm}"]["ok"]
    assert wide[f"windows_{arm}"]["ok"]


def test_launches_per_step_and_eval_batch():
    """2 K1 / 4 L1 per training step and validation batch, 3 / 16 per
    eval batch of 256, for every arm."""
    r = {"train": {"steps": 180, "val_batches": 20},
         "eval": {"batches": 8}}
    for arm in ablation.ARMS:
        assert ablation.launches_want(ablation.arm_cfg(arm), r) == (
            (400, 800), (24, 128))


def test_flags_roundtrip_and_verdict():
    rng = np.random.default_rng(0)
    a = rng.random(2000) < 0.89
    b = a.copy()
    b[:40] = ~b[:40]
    rec = ablation.pack_flags("mlp_qp_grad", a)
    assert json.loads(json.dumps(rec))["n"] == 2000
    assert np.array_equal(ablation.unpack_flags(rec), a)
    records = ablation.read_json(ablation.RECORDS)
    v = ablation.verdicts({"mlp_qp_grad": a, "mlp_supervised": b}, records)
    assert list(v) == ["mlp"]
    m = v["mlp"]["mcnemar"]
    assert m == heldout_eval.mcnemar(a, b)
    assert m["b_only_first"] + m["c_only_second"] == 40
    assert v["mlp"]["record_winner"] == "mlp_qp_grad"
    assert ablation.verdicts({"mlp_qp_grad": a}, records) == {}


# ---- the module's run on the CPU -------------------------------------------

def test_run_on_the_cpu(tmp_path):
    """Both MLP arms, one epoch of 2 steps on a prepared corpus of 300
    held-out rows, eval over 64: every step finite, each arm's files,
    the family's McNemar from the two flag vectors; gates (b) and (c) go
    ungated where the cut leaves nothing (no window covered: refused)."""
    corpus = str(tmp_path / "rows.npz")
    dataset.write_npz(corpus, heldout_eval.load_scenarios(300))
    ev = str(tmp_path / "eval.npz")
    dataset.write_npz(ev, heldout_eval.load_scenarios(64))
    out = ablation.run(["mlp_qp_grad", "mlp_supervised"], "cpu", corpus,
                       epochs=1, eval_path=ev, out_dir=str(tmp_path / "out"),
                       work=str(tmp_path / "work"), log=lambda s: None)
    assert out["prefix"] is None
    for arm in ("mlp_qp_grad", "mlp_supervised"):
        r = out["arms"][arm]
        assert r["steps"] == 2 and r["rows"] == 300 and not r["uncut"]
        assert r["eval_fresh"]["n"] == 64
        assert r["eval_fresh"]["stop_token_accuracy"] == 1.0
        d = tmp_path / "out" / arm
        assert {p.name for p in d.iterdir()} == {
            "metrics.jsonl", "dataset.json", "eval_fresh.json",
            "eval_flags.json", "result.json"}
        flags = ablation.unpack_flags(json.loads(
            (d / "eval_flags.json").read_text()))
        assert flags.mean() == r["eval_fresh"]["success_rate"]
        assert f"eval_{arm}" not in out["gates"]["checks"]
        assert out["gates"]["checks"][f"windows_{arm}"]["finite"]
        assert not out["gates"]["checks"][f"windows_{arm}"]["ok"]
    assert set(out["verdicts"]) == {"mlp"}
