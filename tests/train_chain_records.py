"""The figures of the JAX package's training-chain records that the
port's `train/chain.py` gates read, written into RECORD.

It reads `runs/` (the card runs without these logs, metrics and eval
files, so the gates read this record): the loss windows of the three runs'
`metrics.jsonl` (big3's file holds a first attempt of 224 steps and then
the whole run; the whole run's steps are taken), each arm's
`calibration.json` grid, the refinement statistics of
`runs/refine_targets.log` (its last line) and each arm's
`eval_fresh*.json`.

    python -m tests.train_chain_records
"""

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(ROOT, "runs")
RECORD = os.path.join(ROOT, "tests", "records", "train_chain_records.json")
ARMS = ("big3", "big4", "finetune")
WINDOWS = ((1, 10), (11, 90), (91, 180))
FIELDS = ("obj", "obj1", "objt", "objc", "stop", "success_rate",
          "time_segment_accuracy")


def last_run(path: str) -> list:
    """The step records of the file's last run (from its last step 1)."""
    with open(path) as f:
        steps = [r for r in map(json.loads, f) if "step" in r]
    first = max(i for i, r in enumerate(steps) if r["step"] == 1)
    return steps[first:]


def windows(steps: list) -> dict:
    out = {}
    for a, b in WINDOWS:
        w = [r for r in steps if a <= r["step"] <= b]
        out[f"{a}-{b}"] = {k: float(np.mean([r[k] for r in w]))
                           for k in FIELDS}
        out[f"{a}-{b}"]["steps"] = len(w)
    return out


def main() -> dict:
    rec = {"made_by": "tests/train_chain_records.py", "windows": {},
           "step1": {}, "calibration": {}, "eval_fresh": {}}
    for arm in ARMS:
        steps = last_run(os.path.join(RUNS, arm, "metrics.jsonl"))
        rec["windows"][arm] = windows(steps)
        rec["step1"][arm] = {k: steps[0][k] for k in FIELDS}
        with open(os.path.join(RUNS, arm, "calibration.json")) as f:
            rec["calibration"][arm] = json.load(f)
        rec["eval_fresh"][arm] = {}
        for name in ("eval_fresh", "eval_fresh_calibrated"):
            with open(os.path.join(RUNS, arm, name + ".json")) as f:
                ev = json.load(f)
            # paths of the machine that wrote the record, from runs/ on
            rec["eval_fresh"][arm][name] = {
                k: v[v.index("runs/"):] if isinstance(v, str) and "/runs/" in v
                else v for k, v in ev.items()}
    with open(os.path.join(RUNS, "refine_targets.log")) as f:
        rec["refine_targets"] = json.loads(f.read().strip().splitlines()[-1])
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    r = main()
    print(json.dumps({"windows": r["windows"],
                      "refine_targets": r["refine_targets"]}))
