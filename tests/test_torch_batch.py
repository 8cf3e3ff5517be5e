"""cuopt_torch's batch LP against cuopt_tpu's, on CPU tensors, float64.

Per major: both packages run their batched major (cuopt_tpu a vmapped
jitted major, the port a vmapped attempt in a masked host loop) from the
same stacked device problem and state, carried across member by member,
for each stacked operator: dense, block-band (one sparsity pattern) and
ELL (several). Each member must take the same steps and attempts and
report the same termination information within 1e-8 relative, and the
port's batched major must match its own solo major on every member. As in
tests/test_torch_pdlp.py, each major starts again from cuopt_tpu's state:
last-bit differences (sums taken in another order) grow by orders of
magnitude per major, so end to end a member can stop one major earlier or
later in one package than in the other.

End to end, `batch_solve` solves to 1e-8 and must give each member the
status and, within 1e-6 relative, the objective of cuopt_tpu's
`batch_solve` and of its own solo `solve_lp`.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import cuopt_torch.lp.batch as TB  # noqa: E402
import cuopt_torch.lp.pdlp as T  # noqa: E402
import cuopt_tpu.lp.batch as JB  # noqa: E402
import cuopt_tpu.lp.pdlp as J  # noqa: E402
from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings as TSettings  # noqa: E402
from cuopt_torch.lp.solve import solve_lp as t_solve_lp  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate  # noqa: E402
from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402

torch.set_num_threads(1)

# the dense limit each kind is reached under, at these small sizes
_DENSE_LIMIT = {"dense": 1 << 21, "blockband": 0, "ell": 0}


def _members(generate, kind, n=200, B=4):
    """B same-shape LPs: one pattern with moved bounds and objectives
    (dense, blockband), or B patterns (ell)."""
    rng = np.random.default_rng(0)
    if kind == "ell":
        return [generate(n, n, 5, seed=s, band=64) for s in range(3, 3 + B)]
    base = generate(n, n, 5, seed=3, band=64)
    return [dataclasses.replace(
        base,
        objective_coefficients=base.objective_coefficients * (1 + 0.1 * k),
        constraint_upper_bounds=base.constraint_upper_bounds
        + rng.uniform(0, 0.5, base.n_constraints))
        for k in range(B)]


def _settings(S, tol=1e-4):
    s = S()
    s.log_to_console = False
    s.method = C.CUOPT_METHOD_PDLP
    s.iteration_limit = 20000
    s.set_optimality_tolerance(tol)
    return s


def _arrays(obj):
    """A cuopt_tpu dataclass (device problem, operator or state) as the
    dict of numpy arrays and Python values the port's builders take."""
    out = {}
    if hasattr(obj, "row_vals") or hasattr(obj, "mat") or \
            hasattr(obj, "row_slabs"):
        out["kind"] = type(obj).__name__
    for f in dataclasses.fields(obj):
        if f.name in ("mesh", "ext_row_slabs", "ext_row_starts",
                      "halo_meta"):
            continue
        v = getattr(obj, f.name)
        if f.name in ("op", "inner"):
            out[f.name] = _arrays(v)
        elif v is None or not hasattr(v, "shape"):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-12), initial=0.0))


@pytest.fixture
def dense_limit(monkeypatch):
    def set_kind(kind):
        monkeypatch.setattr(TB, "_BATCH_DENSE_LIMIT", _DENSE_LIMIT[kind])
        monkeypatch.setattr(JB, "_BATCH_DENSE_LIMIT", _DENSE_LIMIT[kind])
    return set_kind


@pytest.mark.parametrize("kind", ["dense", "blockband", "ell"])
def test_batched_majors_match(kind, dense_limit):
    dense_limit(kind)
    t_probs, j_probs = _members(t_generate, kind), _members(j_generate, kind)
    assert TB._pick_batch_kind(t_probs) == JB._pick_batch_kind(j_probs) \
        == kind
    js = J.PdlpSolver(j_probs[0], _settings(JSettings))
    hp = js.hp
    j_devs = [J.build_device_problem(p, hp, jnp.float64, kind)
              for p in j_probs]
    j_states = [J.initial_state(d, hp, jnp.float64) for d in j_devs]
    if kind == "ell":
        j_devs = JB._normalize_ell_widths(j_devs)
    stack = lambda xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)  # noqa
    j_dev_b, j_st_b = stack(j_devs), stack(j_states)
    j_major = JB._batch_major_fn(js.cfg)

    cfg = T.StaticCfg(**{f.name: getattr(js.cfg, f.name)
                         for f in dataclasses.fields(js.cfg)})
    cfg = dataclasses.replace(cfg, fused_kernel="off")
    t_devs = [T.device_problem_from_arrays(_arrays(d), "cpu")
              for d in j_devs]
    t_dev_b = TB._stack(t_devs)
    B = len(t_probs)
    for k in range(3):
        # each major starts from cuopt_tpu's state (module docstring)
        t_states = [T.state_from_arrays(_arrays(jax.tree.map(
            lambda a, b=b: a[b], j_st_b)), "cpu") for b in range(B)]
        fns = TB._batched_fns(cfg, t_devs[0], t_states[0])
        t_st_b, tr = TB._batched_major(fns, t_dev_b, TB._stack(t_states),
                                       cfg)
        j_st_b, jr = j_major(j_dev_b, j_st_b)
        for key in ("total_steps", "total_attempts", "did_restart"):
            assert np.array_equal(tr[key].numpy(), np.asarray(jr[key])), \
                (k, key)
        for key, v in jr["info_cur"].items():
            assert _rel(tr["info_cur"][key].numpy(), v) < 1e-8, (k, key)
        # the port's batched major against its own solo major
        for b in range(B):
            s_b, r_b = T.make_major_fn(cfg)(t_devs[b], t_states[b])
            assert int(r_b["total_attempts"]) == \
                int(tr["total_attempts"][b]), (k, b)
            assert _rel(t_st_b["x"][b].numpy(), s_b.x.numpy()) < 1e-10, \
                (k, b)


@pytest.mark.parametrize("kind", ["dense", "blockband", "ell"])
def test_batch_solve_matches(kind, dense_limit):
    dense_limit(kind)
    t_probs = _members(t_generate, kind, n=150, B=3)
    j_probs = _members(j_generate, kind, n=150, B=3)
    t_sols = TB.batch_solve(t_probs, _settings(TSettings, 1e-8),
                            device="cpu")
    j_sols = JB.batch_solve(j_probs, _settings(JSettings, 1e-8))
    for p, t, j in zip(t_probs, t_sols, j_sols):
        assert t._raw["solved_by"] == "pdlp_batch"
        assert t.get_termination_reason() == j.get_termination_reason() \
            == "Optimal"
        a, b = t.get_primal_objective(), j.get_primal_objective()
        assert abs(a - b) <= 1e-6 * abs(b), (a, b)
        solo = t_solve_lp(dataclasses.replace(p),
                          _settings(TSettings, 1e-8), device="cpu")
        assert solo.get_termination_reason() == "Optimal"
        c = solo.get_primal_objective()
        assert abs(a - c) <= 1e-6 * abs(c), (a, c)


def test_mixed_shapes_go_solo():
    """Groups of one are solved alone, by solve_lp with the same
    settings."""
    probs = [t_generate(150, 150, 5, seed=1, band=64),
             t_generate(160, 150, 5, seed=2, band=64)]
    sols = TB.batch_solve(probs, _settings(TSettings), device="cpu")
    for p, sol in zip(probs, sols):
        assert sol._raw.get("solved_by") != "pdlp_batch"
        solo = t_solve_lp(dataclasses.replace(p), _settings(TSettings),
                          device="cpu")
        assert sol.get_termination_reason() == "Optimal"
        assert sol.get_primal_objective() == solo.get_primal_objective()


def test_failure_inside_stacked_solve_raises(monkeypatch):
    """No fallback: an error in the stacked program reaches the caller."""
    def broken(*a, **k):
        raise RuntimeError("stacked major failed")

    monkeypatch.setattr(TB, "major_tail", broken)
    with pytest.raises(RuntimeError, match="stacked major failed"):
        TB.batch_solve(_members(t_generate, "dense", n=100, B=2),
                       _settings(TSettings), device="cpu")


def test_too_large_group_goes_solo(monkeypatch):
    monkeypatch.setattr(TB, "_BATCH_DENSE_LIMIT", 0)
    monkeypatch.setattr(TB, "_BATCH_ELL_LIMIT", 0)
    probs = _members(t_generate, "ell", n=130, B=2)
    assert TB._pick_batch_kind(probs) is None
    sols = TB.batch_solve(probs, _settings(TSettings), device="cpu")
    assert all(s._raw.get("solved_by") != "pdlp_batch" for s in sols)
