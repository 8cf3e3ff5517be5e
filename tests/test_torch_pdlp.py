"""cuopt_torch's PDLP against cuopt_tpu's, on CPU tensors.

Per major iteration: both packages start each of the first three majors
from the same device problem and state (cuopt_tpu's, carried across with
`device_problem_from_arrays` / `state_from_arrays`) and must agree within
1e-8 relative, in float64.

End to end: `solve_lp` in both packages on the same instance must reach
the same status and an objective within 1e-6 relative in float64. PDLP's
iterates are chaotic in the last bits: cuopt_tpu run against itself with
two operators that sum in another order (dense vs csr) drifts from 1e-13
to 1e-7 relative in four majors. So the end-to-end runs solve to 1e-8,
where both land within 1e-8 of the optimum, rather than to the default
1e-4, where each stops at a different point of the tolerance ball.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import cuopt_torch.lp.pdhg_fused as tf  # noqa: E402
import cuopt_torch.lp.pdlp as T  # noqa: E402
import cuopt_tpu.lp.pdlp as J  # noqa: E402
from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings as TSettings  # noqa: E402
from cuopt_torch.lp.solve import solve_lp as t_solve_lp  # noqa: E402
from cuopt_torch.problem.mittelmann import GENERATORS as T_GEN  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate  # noqa: E402
from cuopt_torch.sparse import BlockBandOp  # noqa: E402
from cuopt_torch.sparse.reorder import permute_csr  # noqa: E402
from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings  # noqa: E402
from cuopt_tpu.lp.solve import solve_lp as j_solve_lp  # noqa: E402
from cuopt_tpu.problem.mittelmann import GENERATORS as J_GEN  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402

torch.set_num_threads(1)

_PRESETS = [C.CUOPT_PDLP_SOLVER_MODE_STABLE1, C.CUOPT_PDLP_SOLVER_MODE_STABLE2,
            C.CUOPT_PDLP_SOLVER_MODE_METHODICAL1,
            C.CUOPT_PDLP_SOLVER_MODE_FAST1]


# ------------------------------------------------ carrying state across
def _op_arrays(op):
    d = {"kind": type(op).__name__}
    for f in dataclasses.fields(op):
        if f.name in ("mesh", "ext_row_slabs", "ext_row_starts",
                      "halo_meta"):
            continue
        v = getattr(op, f.name)
        if f.name == "inner":
            d[f.name] = _op_arrays(v)
        else:
            d[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return d


def _dev_arrays(dev):
    out = {}
    for f in dataclasses.fields(dev):
        v = getattr(dev, f.name)
        if f.name == "op":
            out[f.name] = _op_arrays(v)
        else:
            out[f.name] = None if v is None else np.asarray(v)
    return out


def _state_arrays(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-12), initial=0.0))


@pytest.mark.parametrize("kind", ["auto", "blockband"])
@pytest.mark.parametrize("mode", _PRESETS[:3])
def test_major_iterations_match(mode, kind):
    """Fast1 is left out here: it runs without Ruiz scaling, and on this
    instance last-bit differences grow to ~1e-8 within one major (8e-9
    dense, 1.1e-8 blockband), at the edge of the tolerance. The end-to-end
    test below covers it."""
    prob = j_generate(384, 384, 5, seed=11, band=64)
    settings = JSettings()
    settings.pdlp_solver_mode = mode
    j_solver = J.PdlpSolver(prob, settings)
    hp = j_solver.hp
    j_dev = J.build_device_problem(prob, hp, jnp.float64, kind)
    j_state = J.initial_state(j_dev, hp, jnp.float64)
    t_dev = T.device_problem_from_arrays(_dev_arrays(j_dev), "cpu")
    assert type(t_dev.op).__name__ == type(j_dev.op).__name__
    cfg = T.StaticCfg(**{f.name: getattr(j_solver.cfg, f.name)
                         for f in dataclasses.fields(j_solver.cfg)})
    j_major = J.make_major_fn(j_solver.cfg)
    t_major = T.make_major_fn(cfg)
    for k in range(3):
        # each major starts from cuopt_tpu's state: last-bit differences
        # would otherwise grow by orders of magnitude per major (see the
        # module docstring), as they do between two cuopt_tpu runs
        t_state = T.state_from_arrays(_state_arrays(j_state), "cpu")
        assert t_state.total_steps.dtype == torch.int64
        j_state, jr = j_major(j_dev, j_state)
        t_state, tr = t_major(t_dev, t_state)
        assert int(tr["total_steps"]) == int(jr["total_steps"])
        assert int(tr["total_attempts"]) == int(jr["total_attempts"])
        assert bool(tr["did_restart"]) == bool(jr["did_restart"]), k
        assert _rel(tr["kkt_cur"], jr["kkt_cur"]) < 1e-8, k
        for key, v in jr["info_cur"].items():
            assert _rel(tr["info_cur"][key], v) < 1e-8, (k, key)


def _settings(S, tol=1e-8, **kw):
    s = S()
    s.log_to_console = False
    s.method = C.CUOPT_METHOD_PDLP
    s.iteration_limit = 20000
    s.set_optimality_tolerance(tol)
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _assert_same_solution(t_sol, j_sol, rtol):
    assert t_sol.get_termination_reason() == j_sol.get_termination_reason()
    assert t_sol.get_termination_reason() == "Optimal"
    a, b = t_sol.get_primal_objective(), j_sol.get_primal_objective()
    assert abs(a - b) <= rtol * abs(b), (a, b)
    assert t_sol.get_primal_solution().shape == \
        j_sol.get_primal_solution().shape


@pytest.mark.parametrize("mode", _PRESETS)
def test_solve_matches_presets(mode):
    t_sol = t_solve_lp(t_generate(384, 384, 5, seed=11, band=64),
                       _settings(TSettings, pdlp_solver_mode=mode),
                       device="cpu")
    j_sol = j_solve_lp(j_generate(384, 384, 5, seed=11, band=64),
                       _settings(JSettings, pdlp_solver_mode=mode))
    _assert_same_solution(t_sol, j_sol, 1e-6)


@pytest.mark.parametrize("family,scale", [
    ("set-cover", 200), ("netflow-dense", 100), ("l1-fitting", 200),
])
def test_solve_matches_generators(family, scale):
    t_sol = t_solve_lp(T_GEN[family](scale, 0), _settings(TSettings),
                       device="cpu")
    j_sol = j_solve_lp(J_GEN[family](scale, 0), _settings(JSettings))
    _assert_same_solution(t_sol, j_sol, 1e-6)


def _shuffled(generate, n=1024):
    """A banded LP under a random row+column permutation (as bench.py
    builds its shuffled instance), so that `operator_kind="bandperm"`
    has to recover the band."""
    prob = generate(n, n, 6, seed=5, band=96)
    rng = np.random.default_rng(9)
    rp, cp = rng.permutation(n), rng.permutation(n)
    off, idx, val = permute_csr(prob.offsets, prob.indices,
                                np.asarray(prob.values, np.float64),
                                rp, cp, n, n)
    return dataclasses.replace(
        prob, offsets=off, indices=idx, values=val,
        constraint_lower_bounds=prob.constraint_lower_bounds[rp],
        constraint_upper_bounds=prob.constraint_upper_bounds[rp],
        objective_coefficients=prob.objective_coefficients[cp],
        variable_lower_bounds=prob.variable_lower_bounds[cp],
        variable_upper_bounds=prob.variable_upper_bounds[cp],
        variable_names=[], row_names=[])


def test_solve_matches_absorbed_permutation():
    """operator_kind="bandperm": the PermutedOp is absorbed into the
    problem and the solution comes back in user order."""
    kw = dict(operator_kind="bandperm")
    t_prob, j_prob = _shuffled(t_generate), _shuffled(j_generate)
    t_sol = t_solve_lp(t_prob, _settings(TSettings, 1e-7, **kw),
                       device="cpu")
    j_sol = j_solve_lp(j_prob, _settings(JSettings, 1e-7, **kw))
    _assert_same_solution(t_sol, j_sol, 1e-6)
    t_dev = T.cached_device_problem(t_prob)
    assert isinstance(t_dev.op, BlockBandOp) and t_dev.col_perm is not None
    # the user-order primal solution is feasible for the user's problem
    x = t_sol.get_primal_solution()
    act = T._host_activity(t_prob, np.asarray(x, np.float64))
    assert np.all(act <= t_prob.constraint_upper_bounds + 1e-5)


def _infeasible(generate, n=128):
    """A small staircase LP plus a copy of row 0 whose lower bound lies
    above row 0's upper bound: primal infeasible, with the dual ray
    y = e_copy - e_0."""
    p = generate(n, n, 4, seed=3, band=32)
    a, b = p.offsets[0], p.offsets[1]
    lb = p.constraint_upper_bounds[0] + 1.0
    return dataclasses.replace(
        p, offsets=np.append(p.offsets, p.offsets[-1] + (b - a)),
        indices=np.append(p.indices, p.indices[a:b]),
        values=np.append(p.values, p.values[a:b]),
        constraint_lower_bounds=np.append(p.constraint_lower_bounds, lb),
        constraint_upper_bounds=np.append(p.constraint_upper_bounds, np.inf),
        row_types=np.append(p.row_types, "G"), rhs=np.append(p.rhs, lb),
        row_names=[])


def _unbounded(generate, n=128, cost=-10.0):
    """A small staircase LP plus a variable in no row, with `cost` and no
    upper bound: dual infeasible, with the primal ray x = e_new.

    The cost -10 gives the ray's flag a margin. The two packages sum in
    another order, so their iterates differ in the last bits from the
    first step (`test_first_step_agrees_to_rounding`). With cost -1 this
    LP amplified that about a thousandfold a major, and its best ray
    score per major stayed near the 1e-3 tolerance until the iterates had
    drifted apart, so the packages flagged different majors and stopped
    at different steps. `_unbounded_drift` measures both; with cost -10
    the scores are far from the tolerance at every major
    (`test_unbounded_flag_has_a_margin`)."""
    p = generate(n, n, 4, seed=3, band=32)
    return dataclasses.replace(
        p, objective_coefficients=np.append(p.objective_coefficients, cost),
        variable_lower_bounds=np.append(p.variable_lower_bounds, 0.0),
        variable_upper_bounds=np.append(p.variable_upper_bounds, np.inf),
        variable_types=np.append(p.variable_types, "C"), variable_names=[])


# the unbounded instance's primal ray shows only slowly in the iterates
# (the other variables' share of the ray candidate shrinks with each
# restart), so it is certified at a dual-infeasibility tolerance of 1e-3
_DETECT = {
    "infeasible": (_infeasible, "primal_infeasible", 1e-8,
                   C.CUOPT_TERIMINATION_STATUS_INFEASIBLE),
    "unbounded": (_unbounded, "dual_infeasible", 1e-3,
                  C.CUOPT_TERIMINATION_STATUS_UNBOUNDED),
}


def _from_cuopt_tpu(prob, dual_tol=1e-3):
    """cuopt_tpu's scaled float64 problem and initial state for `prob`
    with infeasibility detection on, both carried over to the port, and
    each package's major function."""
    settings = JSettings()
    settings.detect_infeasibility = True
    settings.tolerances.dual_infeasible_tolerance = dual_tol
    j_solver = J.PdlpSolver(prob, settings)
    j_dev = J.build_device_problem(prob, j_solver.hp, jnp.float64)
    j_state = J.initial_state(j_dev, j_solver.hp, jnp.float64)
    t_dev = T.device_problem_from_arrays(_dev_arrays(j_dev), "cpu")
    t_state = T.state_from_arrays(_state_arrays(j_state), "cpu")
    cfg = T.StaticCfg(**{f.name: getattr(j_solver.cfg, f.name)
                         for f in dataclasses.fields(j_solver.cfg)})
    return (j_dev, j_state, J.make_major_fn(j_solver.cfg), j_solver.cfg,
            t_dev, t_state, T.make_major_fn(cfg), cfg)


def _gap(t, j):
    """max |t - j| over max |j|."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def _unbounded_drift(cost, majors, dual_tol=1e-3):
    """The unbounded LP with `cost` on its free variable, run by both
    packages from cuopt_tpu's scaled problem and initial state, each on
    its own iterates. Per major: x's gap to cuopt_tpu's (`_gap`), the
    port's best ray score as a multiple of the dual-infeasibility
    tolerance (the smaller max_primal_ray_infeasibility of the two
    candidates `_infeasibility_flags` scores), and whether each package
    flagged the major dual infeasible."""
    (j_dev, j_state, j_major, _, t_dev, t_state, t_major,
     _) = _from_cuopt_tpu(_unbounded(j_generate, cost=cost), dual_tol)
    scores = []
    score = T._ray_scores

    def recording(*args):
        out = score(*args)
        scores.append(float(out["max_primal_ray_infeasibility"]))
        return out

    rows = []
    T._ray_scores = recording
    try:
        for _ in range(majors):
            scores.clear()
            t_state, tr = t_major(t_dev, t_state)
            j_state, jr = j_major(j_dev, j_state)
            rows.append((_gap(t_state.x, j_state.x), min(scores) / dual_tol,
                         bool(tr["dual_infeasible"]),
                         bool(jr["dual_infeasible"])))
    finally:
        T._ray_scores = score
    return rows


def test_first_step_agrees_to_rounding():
    """From one scaled problem and state, one PDHG step of each package on
    the unbounded LP that drifted (cost -1) agrees to a few ulps: the
    packages differ in the order of their sums, not in a formula."""
    (j_dev, j_state, _, j_cfg, t_dev, t_state, _,
     t_cfg) = _from_cuopt_tpu(_unbounded(j_generate, cost=-1.0))
    js = jax.jit(lambda d, s: J._take_step(d, s, j_cfg))(j_dev, j_state)
    one = dataclasses.replace(
        t_cfg, hp=dataclasses.replace(t_cfg.hp, major_iteration=1))
    ts = T.make_major_fn(one).steps(t_dev, t_state)
    for name in ("x", "y", "ax", "aty", "step_size"):
        assert _gap(getattr(ts, name), getattr(js, name)) < 1e-15, name
    assert int(ts.total_attempts) == int(js.total_attempts)


def test_unbounded_flag_has_a_margin():
    """The unbounded instance's ray scores stay far from the tolerance at
    every major while the iterates agree, so rounding cannot move the
    major at which either package flags it (see `_unbounded`)."""
    for k, (gap, score, t_flag, j_flag) in enumerate(
            _unbounded_drift(-10.0, 4)):
        assert gap < 1e-9, (k, gap)
        assert score > 2.0 or score < 0.5, (k, score)
        assert t_flag == j_flag, k


def _close(a, b, rtol=1e-8, atol=1e-12):
    return abs(float(a) - float(b)) <= atol + rtol * abs(float(b))


_DUAL_KEYS = ("has_dual_ray", "max_dual_ray_infeasibility",
              "dual_ray_objective")


def _dual_ray_oracle(prob, yr):
    """The dual-ray scores of `_ray_scores` for a user-space row vector
    `yr`, in float64 numpy on the unscaled host matrix: the Farkas
    quantities for y = yr / max|yr| and A^T y."""
    eps = 1e-32
    y_norm = max(float(np.max(np.abs(yr), initial=0.0)), 0.0)
    yn = yr / (y_norm + eps)
    yp, ym = np.maximum(yn, 0.0), np.maximum(-yn, 0.0)
    rows = np.repeat(np.arange(prob.n_constraints), np.diff(prob.offsets))
    aty = np.zeros(prob.n_variables)
    np.add.at(aty, prob.indices, prob.values * yr[rows])
    r = -aty / (y_norm + eps)
    rp, rm = np.maximum(r, 0.0), np.maximum(-r, 0.0)
    lc, uc = prob.constraint_lower_bounds, prob.constraint_upper_bounds
    lv, uv = prob.variable_lower_bounds, prob.variable_upper_bounds
    fin = [np.isfinite(v) for v in (lc, uc, lv, uv)]

    def max0(v):
        return max(float(np.max(v, initial=0.0)), 0.0)

    viol = max(max0(np.where(fin[0], 0.0, yp)),
               max0(np.where(fin[1], 0.0, ym)),
               max0(np.where(fin[2], 0.0, rp)),
               max0(np.where(fin[3], 0.0, rm)))
    obj = (np.sum(np.where(fin[0], np.where(fin[0], lc, 0.0) * yp, 0.0)
                  - np.where(fin[1], np.where(fin[1], uc, 0.0) * ym, 0.0))
           + np.sum(np.where(fin[2], np.where(fin[2], lv, 0.0) * rp, 0.0)
                    - np.where(fin[3], np.where(fin[3], uv, 0.0) * rm, 0.0)))
    return dict(has_dual_ray=y_norm > 0.0, max_dual_ray_infeasibility=viol,
                dual_ray_objective=float(obj))


@pytest.mark.parametrize("case", sorted(_DETECT))
def test_infeasibility_flags_match(case):
    """detect_infeasibility: from the same state each major, the port's
    ray candidates score as cuopt_tpu's on the primal ray and as the
    float64 Farkas oracle on the dual ray, the port raises exactly the
    flags those scores imply, and the instance's own flag fires.

    The dual ray is held against the oracle, not against cuopt_tpu:
    cuopt_tpu evaluates A^T R^2 y where A^T y is meant (pdlp.py:416, R the
    row scales), which the port does not copy."""
    make, flag, dual_tol, _ = _DETECT[case]
    prob = make(j_generate)
    settings = JSettings()
    settings.detect_infeasibility = True
    settings.tolerances.dual_infeasible_tolerance = dual_tol
    j_solver = J.PdlpSolver(prob, settings)
    hp = j_solver.hp
    j_dev = J.build_device_problem(prob, hp, jnp.float64)
    j_state = J.initial_state(j_dev, hp, jnp.float64)
    t_dev = T.device_problem_from_arrays(_dev_arrays(j_dev), "cpu")
    assert t_dev.col_perm is None  # rays in user order
    cfg = T.StaticCfg(**{f.name: getattr(j_solver.cfg, f.name)
                         for f in dataclasses.fields(j_solver.cfg)})
    assert cfg.detect_infeasibility
    j_major = J.make_major_fn(j_solver.cfg)
    t_major = T.make_major_fn(cfg)
    fired = 0
    col, row = np.asarray(j_dev.col_scale), np.asarray(j_dev.row_scale)
    for k in range(12):
        t_state = T.state_from_arrays(_state_arrays(j_state), "cpu")
        # the flags read the iterates after the major's steps, before its
        # restart: score the same candidates both ways there
        t_state = t_major.steps(t_dev, t_state)
        arrays = {f: getattr(t_state, f).numpy() for f in
                  ("x", "y", "x_last_restart", "y_last_restart")}
        rays = (((arrays["x"] - arrays["x_last_restart"]) * col,
                 (arrays["y"] - arrays["y_last_restart"]) * row),
                (arrays["x"] * col, arrays["y"] * row))
        want = {"primal_infeasible": False, "dual_infeasible": False}
        for xr, yr in rays:
            js = J._ray_scores(j_dev, jnp.asarray(xr), jnp.asarray(yr))
            ts = T._ray_scores(t_dev, torch.as_tensor(xr), torch.as_tensor(yr))
            oracle = _dual_ray_oracle(prob, yr)
            for key, v in js.items():
                ref = oracle[key] if key in _DUAL_KEYS else v
                assert _close(ts[key], ref), (k, key, float(ts[key]),
                                              float(ref))
            want["primal_infeasible"] |= bool(
                oracle["has_dual_ray"]
                and oracle["max_dual_ray_infeasibility"] <= cfg.primal_inf_tol
                and oracle["dual_ray_objective"] > 0.0)
            want["dual_infeasible"] |= bool(
                ts["has_primal_ray"]
                and ts["max_primal_ray_infeasibility"] <= cfg.dual_inf_tol
                and ts["primal_ray_objective"] < 0.0)
        t_state, tr = T.major_tail(t_dev, t_state, cfg)
        j_state, jr = j_major(j_dev, j_state)
        assert int(tr["total_steps"]) == int(jr["total_steps"])
        for key in ("primal_infeasible", "dual_infeasible"):
            assert bool(tr[key]) == want[key], (k, key)
        fired += want[flag]
    assert fired > 0


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", sorted(_DETECT))
def test_infeasibility_detection_matches(case, strict):
    """End to end: the same certificate status as cuopt_tpu; a strict run
    stops at the first flagged major, a non-strict one at the second in a
    row. On the unbounded LP (primal ray) both packages stop after the
    same number of steps. On the infeasible LP the port's dual ray is the
    true A^T y (see test_infeasibility_flags_match), so its steps are held
    against its own majors replayed with the float64 oracle: the solve
    stops at the first major whose oracle-certified flags complete the
    streak."""
    make, _, dual_tol, status = _DETECT[case]
    sols = []
    for S, solve, gen, kw in ((TSettings, t_solve_lp, t_generate,
                               dict(device="cpu")),
                              (JSettings, j_solve_lp, j_generate, {})):
        s = _settings(S, 1e-4, detect_infeasibility=True,
                      strict_infeasibility=strict, iteration_limit=3000)
        s.tolerances.dual_infeasible_tolerance = dual_tol
        sols.append(solve(make(gen), s, **kw))
    t_sol, j_sol = sols
    assert t_sol.get_termination_status() == \
        j_sol.get_termination_status() == status
    steps = [s.get_additional_termination_information()["iterations"]
             for s in sols]
    if case == "unbounded":
        assert steps[0] == steps[1]
        return
    prob = make(t_generate)
    settings = _settings(TSettings, 1e-4, detect_infeasibility=True)
    solver = T.PdlpSolver(prob, settings, "cpu")
    dev = T.build_device_problem(prob, solver.hp, torch.float64, "auto",
                                 "cpu")
    state = T.initial_state(dev, solver.hp, torch.float64)
    cfg = solver.cfg
    driver = T.make_major_fn(cfg)
    streak, need = 0, 1 if strict else 2
    while streak < need:
        state = driver.steps(dev, state)
        rays = [((state.y - state.y_last_restart) * dev.row_scale).numpy(),
                (state.y * dev.row_scale).numpy()]
        state, report = T.major_tail(dev, state, cfg)
        certified = any(
            o["has_dual_ray"] and o["max_dual_ray_infeasibility"] <= 1e-8
            and o["dual_ray_objective"] > 0.0
            for o in (_dual_ray_oracle(prob, y) for y in rays))
        assert bool(report["primal_infeasible"]) == certified
        streak = streak + 1 if certified else 0
    assert steps[0] == int(report["total_steps"])


@pytest.mark.parametrize("option", ["per_constraint_residual",
                                    "save_best_primal_so_far"])
def test_termination_options_match(option):
    """The host-side termination options, end to end at 1e-8 (see the
    module docstring): Optimal in both, objective within 1e-6."""
    t_prob = t_generate(384, 384, 5, seed=11, band=64)
    t_sol = t_solve_lp(t_prob, _settings(TSettings, **{option: True}),
                       device="cpu")
    j_sol = j_solve_lp(j_generate(384, 384, 5, seed=11, band=64),
                       _settings(JSettings, **{option: True}))
    _assert_same_solution(t_sol, j_sol, 1e-6)
    if option == "per_constraint_residual":
        # every constraint meets abs + rel * |b_i| on its own
        x = np.asarray(t_sol.get_primal_solution(), np.float64)
        act = T._host_activity(t_prob, x)
        ub = t_prob.constraint_upper_bounds
        assert np.all(act - ub <= 1e-8 + 1e-8 * np.abs(ub))


def test_first_primal_feasible_matches():
    """first_primal_feasible stops at the first major whose primal
    residual meets its tolerance. With that tolerance at 1e-4 and the
    dual and gap tolerances at 1e-8, both packages stop at the same major,
    long before optimality. The iterates there agree only as far as the
    last-bit drift of the module docstring allows (5e-6 relative after
    440 steps), so the objectives are held to the primal tolerance."""
    sols = []
    for S, solve, gen, kw in ((TSettings, t_solve_lp, t_generate,
                               dict(device="cpu")),
                              (JSettings, j_solve_lp, j_generate, {})):
        s = _settings(S, 1e-8, first_primal_feasible=True)
        s.tolerances.absolute_primal_tolerance = 1e-4
        s.tolerances.relative_primal_tolerance = 1e-4
        sols.append(solve(gen(384, 384, 5, seed=11, band=64), s, **kw))
    t_sol, j_sol = sols
    assert t_sol.get_termination_status() == \
        j_sol.get_termination_status() == \
        C.CUOPT_TERIMINATION_STATUS_PRIMAL_FEASIBLE
    info = [s.get_additional_termination_information() for s in sols]
    assert info[0]["iterations"] == info[1]["iterations"]
    a, b = t_sol.get_primal_objective(), j_sol.get_primal_objective()
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)


def _fused_settings(S):
    s = _settings(S, 1e-3, dtype="float32", operator_kind="blockband")
    s.iteration_limit = 4000
    return s


def test_fused_solve_matches_cuopt_tpu_fused():
    """float32 with the fused pass forced on in both packages (the port's
    plain version, cuopt_tpu's Pallas kernel in interpreter mode), as
    tests/test_pdhg_pallas.py::test_full_solve_fused_matches_xla runs it:
    same status, objective within 1e-3 relative."""
    t_solver = T.PdlpSolver(t_generate(384, 384, 5, seed=11, band=64),
                            _fused_settings(TSettings), device="cpu")
    t_solver.cfg = dataclasses.replace(t_solver.cfg, fused_kernel="on")
    tf.reset_counts()
    t_out = t_solver.run()
    assert tf.PlainCount.calls == t_out["attempts"] > 0
    assert all(k.launches == 0 for k in tf.KERNELS)

    j_solver = J.PdlpSolver(j_generate(384, 384, 5, seed=11, band=64),
                            _fused_settings(JSettings))
    j_solver.cfg = dataclasses.replace(j_solver.cfg, fused_kernel="on")
    j_solver.major_fn = J.make_major_fn(j_solver.cfg)
    j_out = j_solver.run()
    assert t_out["status"] == j_out["status"] == \
        C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    a, b = t_out["primal_objective"], j_out["primal_objective"]
    assert abs(a - b) <= 1e-3 * (1 + abs(b))


def test_fused_and_unfused_agree_float32():
    prob = t_generate(384, 384, 5, seed=11, band=64)
    outs = []
    for fused in ("on", "off"):
        solver = T.PdlpSolver(prob, _fused_settings(TSettings), device="cpu")
        solver.cfg = dataclasses.replace(solver.cfg, fused_kernel=fused)
        tf.reset_counts()
        outs.append(solver.run())
        assert (tf.PlainCount.calls > 0) == (fused == "on")
    assert outs[0]["status"] == outs[1]["status"]
    a, b = outs[0]["primal_objective"], outs[1]["primal_objective"]
    assert abs(a - b) <= 1e-3 * (1 + abs(b))


def test_float64_and_cpu_float32_take_the_unfused_step():
    """"auto" runs the fused pass only for a CUDA float32 operator."""
    prob = t_generate(384, 384, 5, seed=11, band=64)
    for dtype in ("float64", "float32"):
        s = _settings(TSettings, 1e-4, dtype=dtype, operator_kind="blockband")
        s.iteration_limit = 200
        tf.reset_counts()
        T.PdlpSolver(prob, s, device="cpu").run()
        assert tf.PlainCount.calls == 0


def test_device_caches_stay_apart():
    """A problem seen by both packages keeps one device problem each."""
    prob = t_generate(256, 256, 5, seed=2, band=64)
    hp = J.PRESETS[C.CUOPT_PDLP_SOLVER_MODE_STABLE2]
    j_dev = J.build_device_problem(prob, hp, jnp.float64)
    t_dev = T.build_device_problem(prob, hp, torch.float64, device="cpu")
    assert isinstance(t_dev.c, torch.Tensor)
    assert J.build_device_problem(prob, hp, jnp.float64) is j_dev
    assert T.build_device_problem(prob, hp, torch.float64,
                                  device="cpu") is t_dev


def test_methods_without_simplex():
    """The methods that once ran without a simplex in the port: DualSimplex
    and crossover raised, Concurrent ran PDLP alone. Now each reaches the
    simplex's vertex optimum (tests/test_torch_concurrent.py and
    tests/test_torch_dual_simplex.py hold them against cuopt_tpu)."""
    prob = t_generate(128, 128, 4, seed=1, band=32)
    solved_by = {}
    for name, kw in (("dual simplex",
                      dict(method=C.CUOPT_METHOD_DUAL_SIMPLEX)),
                     ("crossover", dict(crossover=True)),
                     ("concurrent", dict(method=C.CUOPT_METHOD_CONCURRENT))):
        sol = t_solve_lp(prob, _settings(TSettings, 1e-4, **kw),
                         device="cpu")
        assert sol.get_termination_reason() == "Optimal", name
        info = sol.get_additional_termination_information()
        solved_by[name] = (info["solved_by"], sol.get_primal_objective())
    # the simplex wins the race on an LP this small
    assert [solved_by[k][0] for k in sorted(solved_by)] == \
        ["dual_simplex", "pdlp+crossover", "dual_simplex"]
    vertex = solved_by["dual simplex"][1]
    for name, (_, obj) in solved_by.items():
        assert abs(obj - vertex) <= 1e-9 * abs(vertex), name


def test_no_constraints_matches():
    from cuopt_torch.lp.solve import _solve_no_constraints as t_nc
    from cuopt_tpu.lp.solve import _solve_no_constraints as j_nc

    prob = t_generate(8, 16, 3, seed=4)
    prob = dataclasses.replace(
        prob, offsets=np.zeros(1, np.int64), indices=prob.indices[:0],
        values=prob.values[:0], constraint_lower_bounds=np.zeros(0),
        constraint_upper_bounds=np.zeros(0), row_types=prob.row_types[:0],
        rhs=np.zeros(0), row_names=[])
    prob.objective_coefficients[::3] *= -1
    t_raw, j_raw = t_nc(prob), j_nc(prob)
    assert t_raw["status"] == j_raw["status"]
    np.testing.assert_array_equal(t_raw["primal_solution"],
                                  j_raw["primal_solution"])
    assert t_raw["primal_objective"] == j_raw["primal_objective"]


def test_feasible_lp_is_not_certified_infeasible():
    """The LP relaxation of the staircase MIP of tests/torch_mip_instances.py
    is feasible (it holds x_hat). With detect_infeasibility on, the port
    solves it to OPTIMAL, while cuopt_tpu's dual-ray check, which
    evaluates A^T R^2 y (pdlp.py:416), certifies it INFEASIBLE after two
    majors: the MIP solver's root relaxation takes exactly these settings
    (mip/solve.py)."""
    from torch_mip_instances import staircase_mip

    sols = []
    for S, solve, gen, kw in ((TSettings, t_solve_lp, t_generate,
                               dict(device="cpu")),
                              (JSettings, j_solve_lp, j_generate, {})):
        s = _settings(S, 1e-6, detect_infeasibility=True)
        sols.append(solve(staircase_mip(gen, 300, 0), s, **kw))
    t_sol, j_sol = sols
    assert t_sol.get_termination_reason() == "Optimal"
    assert j_sol.get_termination_reason() == "Infeasible"
    assert j_sol.get_nb_iterations() == 80
    p, x_hat = staircase_mip(t_generate, 300, 0, with_point=True)
    assert t_sol.get_primal_objective() <= \
        float(p.objective_coefficients @ x_hat) + 1e-6


def test_device_cache_follows_in_place_changes():
    """The device problem cached on a problem object is rebuilt when the
    caller changes its bounds or objective in place, and reused when
    nothing changed."""
    from cuopt_torch.lp.hyper_params import PdlpHyperParams

    prob = t_generate(64, 64, 4, seed=5)
    hp = PdlpHyperParams()
    dev = T.build_device_problem(prob, hp, torch.float64, device="cpu")
    assert T.build_device_problem(prob, hp, torch.float64,
                                  device="cpu") is dev
    assert T.cached_device_problem(prob) is dev
    prob.constraint_upper_bounds[3] += 1.0
    dev2 = T.build_device_problem(prob, hp, torch.float64, device="cpu")
    assert dev2 is not dev
    assert float(dev2.uc_orig[3]) == prob.constraint_upper_bounds[3]
    prob.objective_coefficients[0] = -2.0
    dev3 = T.build_device_problem(prob, hp, torch.float64, device="cpu")
    assert dev3 is not dev2 and float(dev3.c_orig[0]) == -2.0


# ------------------------------------------- the step driver, off a card
def _assert_equal_tensors(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal_tensors(a[k], b[k], (where, k))
    else:
        assert torch.equal(a, b), where


def _oracle_major(dev, s, cfg):
    """A major as a host loop over attempts, each reading its `valid`
    flag (the reference's take_step, pdlp.cu:1188): the driver's oracle."""
    for _ in range(cfg.hp.major_iteration):
        grad, eta, attempts = dev.c - s.aty, s.step_size, 0
        while True:
            cand, valid, eta_next = T._attempt(dev, s, cfg, grad, eta,
                                               attempts)
            attempts += 1
            if attempts >= cfg.max_step_attempts or bool(valid):
                break
            eta = eta_next
        s = T._accept(s, cand, eta, eta_next, attempts)
    return T.major_tail(dev, s, cfg)


def _slot_parity(prob, dtype, kind, cfg_kw, majors=3):
    """`_oracle_major` and the step driver (each slot run eagerly, in its
    rounds) for `majors` majors from one state: every SolverState field
    and every report entry equal, bit for bit. Returns the oracle's state
    and the driver."""
    solver = T.PdlpSolver(prob, TSettings(), device="cpu")
    cfg = dataclasses.replace(solver.cfg, **cfg_kw)
    dev = T.build_device_problem(prob, solver.hp, dtype, kind, "cpu")
    eager_s = slot_s = T.initial_state(dev, solver.hp, dtype)
    driver = T.make_major_fn(cfg)
    for k in range(majors):
        eager_s, eager_r = _oracle_major(dev, eager_s, cfg)
        slot_s, slot_r = driver(dev, slot_s)
        for f in dataclasses.fields(T.SolverState):
            _assert_equal_tensors(getattr(eager_s, f.name),
                                  getattr(slot_s, f.name), (k, f.name))
        _assert_equal_tensors(eager_r, slot_r, k)
    # one slot an attempt; at least one count read a major
    assert driver.slots == int(eager_s.total_attempts)
    assert driver.count_reads >= majors
    return eager_s, driver


@pytest.mark.parametrize("cap", [64, 2])
@pytest.mark.parametrize("kind", ["auto", "blockband"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ping_pong_slots_equal_eager_majors(dtype, kind, cap):
    """Under the default cap, a staircase whose 120 steps take more
    attempts than steps, so slots are rejected; under a cap of 2,
    degen-transport, one of whose steps takes 3 attempts uncapped, so the
    cap forces an accept (the capped path leaves the uncapped one)."""
    if cap == 64:
        prob = t_generate(384, 384, 5, seed=11, band=64)
    else:
        prob = T_GEN["degen-transport"](300, 0)
    s, driver = _slot_parity(prob, dtype, kind, dict(max_step_attempts=cap))
    assert int(s.total_attempts) > int(s.total_steps) == 120
    assert driver.count_reads > 3  # a rejection costs the major a read
    if cap == 2:
        uncapped, _ = _slot_parity(prob, dtype, kind, {}, majors=1)
        capped, _ = _slot_parity(prob, dtype, kind, dict(max_step_attempts=2),
                                 majors=1)
        assert not torch.equal(uncapped.x, capped.x)


def test_ping_pong_slots_equal_eager_majors_on_the_fused_pass():
    """The branch a float32 block band takes on the card: the fused row
    pass, here its plain version, once an attempt in the oracle and in
    the driver."""
    prob = t_generate(384, 384, 5, seed=11, band=64)
    tf.reset_counts()
    s, driver = _slot_parity(prob, torch.float32, "blockband",
                             dict(fused_kernel="on"))
    assert tf.PlainCount.calls == 2 * int(s.total_attempts) > 0
    assert driver.graphs is None  # off a card nothing is captured


def test_slot_refuses_a_field_list_that_differs_from_accept(monkeypatch):
    """The slot's buffers hold `_SLOT_FIELDS`; a field `_accept` writes
    that the list lacks would be dropped from the driver's state, so the
    slot refuses to run with such a list."""
    prob = t_generate(96, 96, 4, seed=3, band=16)
    solver = T.PdlpSolver(prob, TSettings(), device="cpu")
    dev = T.build_device_problem(prob, solver.hp, torch.float64, "auto",
                                 "cpu")
    s = T.initial_state(dev, solver.hp, torch.float64)
    monkeypatch.setattr(T, "_SLOT_FIELDS", tuple(
        f for f in T._SLOT_FIELDS if f != "numerical_error"))
    with pytest.raises(AssertionError, match="numerical_error"):
        T.PingPongMajor(solver.cfg)(dev, s)


def test_driver_follows_a_second_problem():
    """A driver handed another problem allocates anew and runs that
    problem's majors: the staircase, then degen-transport (other shapes),
    then the staircase again, each major equal to the oracle's bit for
    bit. A state the first major returned outlives the majors of the
    other problem and the staircase's new buffers."""
    probs = [t_generate(384, 384, 5, seed=11, band=64),
             T_GEN["degen-transport"](300, 0)]
    solver = T.PdlpSolver(probs[0], TSettings(), device="cpu")
    devs = [T.build_device_problem(p, solver.hp, torch.float64, "auto",
                                   "cpu") for p in probs]
    assert devs[0].op.shape != devs[1].op.shape
    driver = T.make_major_fn(solver.cfg)
    kept = None
    for k, dev in enumerate((devs[0], devs[1], devs[0])):
        s0 = T.initial_state(dev, solver.hp, torch.float64)
        want_s, want_r = _oracle_major(dev, s0, solver.cfg)
        got_s, got_r = driver(dev, s0)
        assert driver.dev is dev
        for f in dataclasses.fields(T.SolverState):
            _assert_equal_tensors(getattr(want_s, f.name),
                                  getattr(got_s, f.name), (k, f.name))
        _assert_equal_tensors(want_r, got_r, k)
        if k == 0:
            kept, kept_copy = got_s, {
                f.name: getattr(got_s, f.name).clone()
                for f in dataclasses.fields(T.SolverState)}
    for name, v in kept_copy.items():
        assert torch.equal(getattr(kept, name), v), name


def _oracle_solve(prob, solver):
    """The solve as a host loop of `_oracle_major`s: (restarts counted
    from each major's `did_restart`, steps, the answer's x and y)."""
    dev = T.build_device_problem(prob, solver.hp, solver.dtype,
                                 solver.settings.operator_kind, "cpu")
    s = T.initial_state(dev, solver.hp, solver.dtype)
    restarts = 0
    while True:
        s, r = _oracle_major(dev, s, solver.cfg)
        restarts += bool(r["did_restart"])
        if bool(r["opt_cur"]) or bool(r["opt_avg"]):
            which = "cur" if bool(r["opt_cur"]) else "avg"
            return (restarts, int(r["total_steps"]),
                    r[f"x_{which}"].numpy(), r[f"y_{which}"].numpy())
        assert int(r["total_steps"]) < solver.settings.iteration_limit


@pytest.mark.parametrize("strategy", ["none", "default"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_restart_count_equals_the_oracles(dtype, strategy):
    """The raw result's `restarts` is the count of majors whose tail set
    `did_restart`, read in the major's one packed readback: 0 with
    restarts off, and with the default strategy the count the host loop
    of eager majors reads; the steps and the answer equal the loop's bit
    for bit."""
    prob = t_generate(384, 384, 5, seed=11, band=64)
    settings = TSettings()
    settings.dtype = dtype
    settings.iteration_limit = 20_000
    solver = T.PdlpSolver(prob, settings, device="cpu")
    if strategy == "none":
        solver.hp = dataclasses.replace(
            solver.hp, restart_strategy=T.RESTART_NONE)
        solver.cfg = dataclasses.replace(solver.cfg, hp=solver.hp)
    sol = solver.run()
    assert sol["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    restarts, steps, x, y = _oracle_solve(prob, solver)
    assert sol["restarts"] == restarts
    assert (restarts == 0) == (strategy == "none")
    assert sol["iterations"] == steps
    np.testing.assert_array_equal(sol["primal_solution"], x)
    np.testing.assert_array_equal(sol["dual_solution"], y)
