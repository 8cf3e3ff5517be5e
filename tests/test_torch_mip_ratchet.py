"""The port's MIP quality ratchet (scripts/torch_mip_benchmark.py).

- Its compare_to_baseline gives the reference's verdicts
  (scripts/mip_benchmark.py) on 200 seeded mutations of a results list
  and a baseline: objectives moved either way, statuses lost or gained,
  gaps widened, infinite or NaN, both senses, missing entries.
- The committed MIP_TORCH_latest.json, written by a run on the card,
  holds against the committed scripts/torch_mip_baseline.json, as
  tests/test_mip_ratchet.py holds MIP_latest.json for cuopt_tpu.
"""

import importlib.util
import json
import math
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = _load(ROOT / "scripts" / "torch_mip_benchmark.py",
             "torch_mip_benchmark")
REF = _load(ROOT / "scripts" / "mip_benchmark.py", "ref_mip_benchmark")


def _mutated(rng):
    """A baseline and a results list around it, mutated at random."""
    names = [f"mip{i}" for i in range(6)]
    baseline, results = {}, []
    for name in names:
        obj = float(rng.normal(0, 100))
        gap = float(rng.choice([0.0, 0.01, 0.3, math.inf]))
        b = {"sense": str(rng.choice(["min", "max"])),
             "status": int(rng.choice([1, 2, 8])),
             "objective": obj, "mip_gap": gap}
        if rng.random() < 0.1:
            del b["sense"]
        if rng.random() < 0.1:
            b["objective"] = None
        if rng.random() < 0.15:
            continue  # no baseline entry
        baseline[name] = b
    for name in names:
        b = baseline.get(name, {})
        base = b.get("objective")
        base = float(rng.normal(0, 100)) if base is None else base
        step = float(rng.choice([0.0, 1e-9, 1e-7, 1e-5, 0.5, 10.0]))
        r = {"instance": name, "mip": bool(rng.random() > 0.1),
             "status": int(rng.choice([1, 1, 2, 8])),
             "objective": base + float(rng.choice([-1.0, 1.0])) * step
             * max(1.0, abs(base)),
             "mip_gap": float(rng.choice([0.0, 0.005, 0.025, 0.5,
                                          math.inf]))}
        u = rng.random()
        if u < 0.05:
            r["objective"] = math.nan
        elif u < 0.1:
            r["objective"] = "parse_error"
        elif u < 0.15:
            r["objective"] = None
        if rng.random() < 0.1:
            r["mip_gap"] = None
        results.append(r)
    return results, baseline


def test_verdicts_equal_the_reference_on_mutations():
    rng = np.random.default_rng(2024)
    flagged = 0
    for k in range(200):
        results, baseline = _mutated(rng)
        ours = PORT.compare_to_baseline(results, baseline)
        ref = REF.compare_to_baseline(results, baseline)
        assert ours == ref, (k, ours, ref)
        flagged += bool(ref)
    assert 20 < flagged < 200  # both verdicts occur


def test_committed_record_holds_against_baseline():
    latest = json.loads((ROOT / "MIP_TORCH_latest.json").read_text())
    baseline = json.loads(
        (ROOT / "scripts" / "torch_mip_baseline.json").read_text())
    assert latest["device"].startswith("NVIDIA H100")
    assert latest["host_check_failed"] == []
    results = latest["results"]
    assert {r["instance"] for r in results} == set(PORT.GENERATED)
    assert set(baseline) == set(PORT.GENERATED)
    assert all(r["host_ok"] for r in results)
    assert PORT.compare_to_baseline(results, baseline) == []
