"""The figures of the JAX package's ablation runs that the port's
`train/ablation.py` gates read, written into RECORD.

It reads `runs/` (the card runs without these metrics and eval files, so
the gates read this record): the loss windows of each arm's
`metrics.jsonl` (`runs/big2`, `runs/ablation/supervised_lstm`,
`runs/ablation/mlp_probe2/{qp_grad,supervised}`; one run each, steps 1 to
the last), each arm's first step and its held-out eval
(`runs/big2/eval_fresh.json`, `runs/ablation/results.json`'s
`supervised`, `runs/ablation/mlp_probe2/results.json`).

    python -m tests.ablation_records
"""

import json
import os

from tests.train_chain_records import FIELDS, last_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
RECORD = os.path.join(ROOT, "tests", "records", "ablation_records.json")
# arm: (metrics file, results file, key in it or None, the script's
# total steps)
SOURCES = {
    "lstm_qp_grad": ("big2/metrics.jsonl", "big2/eval_fresh.json", None,
                     17550),
    "lstm_supervised": ("ablation/supervised_lstm/metrics.jsonl",
                        "ablation/results.json", "supervised", 17550),
    "mlp_qp_grad": ("ablation/mlp_probe2/qp_grad/metrics.jsonl",
                    "ablation/mlp_probe2/results.json", "qp_grad", 1050),
    "mlp_supervised": ("ablation/mlp_probe2/supervised/metrics.jsonl",
                       "ablation/mlp_probe2/results.json", "supervised",
                       1050),
}
WINDOWS = {"lstm": ((1, 10), (11, 90), (91, 180), (2901, 3000),
                    (8901, 9000)),
           "mlp": ((1, 10), (11, 90), (91, 180), (961, 1050))}
EVAL_KEYS = ("n", "success_rate", "stop_token_accuracy",
             "time_segment_accuracy", "mean_obj", "mean_time_ratio")


def windows(steps: list, bounds) -> dict:
    out = {}
    for a, b in bounds:
        w = [r for r in steps if a <= r["step"] <= b]
        assert len(w) == b - a + 1, (a, b, len(w))
        out[f"{a}-{b}"] = {k: sum(r[k] for r in w) / len(w) for k in FIELDS}
        out[f"{a}-{b}"]["steps"] = len(w)
    return out


def main() -> dict:
    rec = {"made_by": "tests/ablation_records.py", "windows": {},
           "step1": {}, "steps": {}, "eval_fresh": {}, "sources": {}}
    for arm, (metrics, results, key, total) in SOURCES.items():
        steps = last_run(os.path.join(RUNS, metrics))
        assert steps[-1]["step"] == total == len(steps), arm
        rec["windows"][arm] = windows(steps, WINDOWS[arm.split("_")[0]])
        rec["step1"][arm] = {k: steps[0][k] for k in FIELDS}
        rec["steps"][arm] = len(steps)
        with open(os.path.join(RUNS, results)) as f:
            ev = json.load(f)
        ev = ev[key] if key else ev
        rec["eval_fresh"][arm] = {k: ev[k] for k in EVAL_KEYS}
        rec["sources"][arm] = ["runs/" + metrics, "runs/" + results
                               + (f" [{key}]" if key else "")]
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    r = main()
    print(json.dumps({"eval_fresh": r["eval_fresh"],
                      "windows_1_10": {a: w["1-10"]["obj"]
                                       for a, w in r["windows"].items()}}))
