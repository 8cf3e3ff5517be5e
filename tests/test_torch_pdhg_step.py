"""The slot's step kernels (lp/pdhg_step.py) through their plain versions,
on CPU tensors, against the torch slot (`lp/pdlp.py _slot`).

On a card every slot of a solo solve runs `pdhg_step.kernel_slot`; on the
CPU and on a mesh the driver runs `_slot`. The two take the same
arithmetic but for the order of five sums, so:
  - the plain slot agrees with `_slot` within 1e-5 x (1 + max|.|) in
    float32 and 1e-12 in float64, field by field;
  - their commit and next attempt index agree exactly, in cases built
    away from eta == eta_limit, where another order of summation may
    rightly flip `valid`.
The kernels against these plain versions are `-m gpu` tests
(tests/test_torch_gpu.py).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cuopt_torch.lp.pdlp as T
from cuopt_torch.lp import pdhg_step as ps
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.parallel.sharding import make_mesh
from cuopt_torch.problem.synthetic import generate_lp

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# (dtype, fused_kernel): the fused row pass's plain version ("on", float32
# block band) and the unfused chain
PATHS = [(torch.float32, "off"), (torch.float32, "on"),
         (torch.float64, "off")]
PATH_IDS = ["f32-unfused", "f32-fused", "f64-unfused"]


def _problem(infinite: bool):
    """The 384 staircase; with `infinite`, a third of the columns free
    below, a third unbounded above, and half the rows ranged (the
    staircase's rows are all `<=`)."""
    prob = generate_lp(384, 384, 5, seed=11, band=64)
    if infinite:
        rng = np.random.default_rng(5)
        m = prob.n_variables
        lv, uv = prob.variable_lower_bounds, prob.variable_upper_bounds
        lv[rng.random(m) < 1 / 3] = -np.inf
        uv[rng.random(m) < 1 / 3] = np.inf
        lc, uc = prob.constraint_lower_bounds, prob.constraint_upper_bounds
        ranged = rng.random(prob.n_constraints) < 0.5
        lc[ranged] = uc[ranged] - 2.0
    return prob


def _setup(dtype, fused_kernel, infinite=False, majors=2):
    """(dev, cfg, state after `majors` majors, work) on the CPU."""
    prob = _problem(infinite)
    solver = T.PdlpSolver(prob, PDLPSolverSettings(), device="cpu")
    cfg = dataclasses.replace(solver.cfg, fused_kernel=fused_kernel)
    dev = T.build_device_problem(prob, solver.hp, dtype, "blockband", "cpu")
    s = T.initial_state(dev, solver.hp, dtype)
    driver = T.make_major_fn(cfg)
    for _ in range(majors):
        s, _ = driver(dev, s)
    s = _copy(s)  # the driver's next major would overwrite it
    fused = T._use_fused(dev, dtype, cfg)
    assert fused == (fused_kernel == "on")
    return dev, cfg, s, ps.step_work(dev, s, fused)


def _copy(s):
    return s.replace(**{f.name: getattr(s, f.name).clone()
                        for f in dataclasses.fields(s)})


def _both_slots(dev, cfg, s, pending, work):
    """(out, out_pending) of `_slot` and of the plain kernel slot from
    the same state."""
    got = []
    for run in (T._slot, lambda *a: ps.kernel_slot(*a, work)):
        out = s.replace(**{f: torch.full_like(getattr(s, f), 7)
                           for f in T._SLOT_FIELDS})
        out_pending = torch.full_like(pending, -1)
        run(dev, s, pending, cfg, out, out_pending)
        got.append((out, out_pending))
    return got


def _assert_close(want, got, dtype):
    for f in T._SLOT_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if a.dtype.is_floating_point:
            a64, b64 = a.double(), b.double()
            assert torch.equal(torch.isnan(a64), torch.isnan(b64)), f
            fin = ~torch.isnan(a64)
            err = (a64[fin] - b64[fin]).abs().max().item() if fin.any() \
                else 0.0
            scale = 1 + a64[fin].abs().max().item() if fin.any() else 1
            assert err <= TOL[dtype] * scale, (f, err)
        else:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("dtype,fused_kernel", PATHS, ids=PATH_IDS)
def test_plain_slot_agrees_with_the_torch_slot(dtype, fused_kernel):
    """Ten slots along the driver's own path: every field within the
    tolerance, the commit and the next attempt index equal."""
    dev, cfg, s, work = _setup(dtype, fused_kernel)
    pending = torch.zeros((), dtype=torch.int64)
    for _ in range(10):
        (want, want_p), (got, got_p) = _both_slots(dev, cfg, s, pending,
                                                   work)
        _assert_close(want, got, dtype)
        assert torch.equal(want_p, got_p)
        s, pending = _copy(want), want_p.clone()


def _valid(dev, cfg, s, eta):
    """Whether `_attempt` from `s` at step size eta is valid."""
    _, valid, _ = T._attempt(dev, s, cfg, dev.c - s.aty, eta,
                             torch.zeros((), dtype=torch.int64))
    return bool(valid)


def _case(dev, cfg, s, case):
    """The state and attempt index of a case, and whether it commits."""
    cap = cfg.max_step_attempts
    eta0 = s.step_size
    if case == "accepted":
        eta, pending = eta0 * 0.05, 0
    elif case == "rejected":
        eta, pending = eta0 * 200.0, 3
    elif case in ("attempt_cap", "nonfinite"):
        eta, pending = eta0 * 200.0, cap - 1
    s = s.replace(step_size=eta.clone())
    if case == "nonfinite":
        x = s.x.clone()
        x[3] = float("nan")
        s = s.replace(x=x)
    else:
        # away from the boundary: the same side at a tenth more or less
        for f in (0.9, 1.1):
            assert _valid(dev, cfg, s, eta * f) == \
                _valid(dev, cfg, s, eta), (case, f)
        assert _valid(dev, cfg, s, eta) == (case == "accepted"), case
    return s, torch.tensor(pending), case in ("accepted", "attempt_cap",
                                              "nonfinite")


@pytest.mark.parametrize("infinite", [False, True],
                         ids=["finite", "infinite-bounds"])
@pytest.mark.parametrize("case", ["accepted", "rejected", "attempt_cap",
                                  "nonfinite"])
@pytest.mark.parametrize("dtype,fused_kernel", PATHS, ids=PATH_IDS)
def test_commit_and_pending_agree_exactly(dtype, fused_kernel, case,
                                          infinite):
    dev, cfg, s, work = _setup(dtype, fused_kernel, infinite)
    if infinite:
        assert not bool(dev.lv_fin.all()) and not bool(dev.uv_fin.all())
        assert bool(dev.lc_fin.any()) and not bool(dev.lc_fin.all())
    s, pending, commits = _case(dev, cfg, s, case)
    (want, want_p), (got, got_p) = _both_slots(dev, cfg, s, pending, work)
    assert torch.equal(want_p, got_p)
    assert int(want_p) == (0 if commits else int(pending) + 1)
    for f in ("total_steps", "total_attempts", "iters_since_restart",
              "numerical_error"):
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    assert int(got.total_steps) == int(s.total_steps) + commits
    assert bool(got.numerical_error) == (case == "nonfinite")
    _assert_close(want, got, dtype)


def test_commit_writes_the_slot_fields():
    """pdhg_commit writes what `_slot` writes: a field of the state left
    out would keep a stale buffer's value."""
    assert set(ps.COMMIT_FIELDS) == set(T._SLOT_FIELDS)
    assert len(ps.COMMIT_FIELDS) == len(T._SLOT_FIELDS)


@pytest.mark.parametrize("length", [0, 1, 1023, 1024, 1025, 49_999,
                                    50_000, 300_000, 1_000_000])
def test_partial_sums_cover_the_vector(length):
    blocks, chunk = ps._split(length)
    assert blocks <= ps.MAX_PARTS
    if length:
        assert chunk >= min(length, ps.CHUNK)
        assert (blocks - 1) * chunk < length <= blocks * chunk
    else:
        assert blocks == 0
    v = torch.arange(length, dtype=torch.float64)
    sums = ps._block_sums(v, blocks, chunk)
    assert sums.shape == (blocks,)
    assert float(sums.sum()) == float(v.sum())


def test_wrappers_refuse_a_device_without_kernels():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ps._on_card(torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel for torch.float16"):
        ps._dbl(torch.float16)


def test_the_step_kernels_are_chosen_on_a_card_without_comm():
    """The selector reads what it can observe: CUDA tensors and no comm.
    Off a card, or on a shard of a mesh, the driver runs `_slot`."""
    on_card = SimpleNamespace(x=SimpleNamespace(is_cuda=True))
    on_cpu = SimpleNamespace(x=SimpleNamespace(is_cuda=False))
    solo = SimpleNamespace(op=SimpleNamespace())
    shard = SimpleNamespace(op=SimpleNamespace(comm=object()))
    assert T._solo_on_card(solo, on_card)
    assert not T._solo_on_card(shard, on_card)
    assert not T._solo_on_card(solo, on_cpu)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_a_cpu_solve_runs_no_step_kernel_slot(dtype):
    prob = generate_lp(384, 384, 5, seed=11, band=64)
    settings = PDLPSolverSettings()
    settings.dtype = dtype
    settings.iteration_limit = 80
    raw = T.PdlpSolver(prob, settings, device="cpu").run()
    assert raw["graph_slots"] == raw["attempts"] >= 80
    assert raw["step_kernel_slots"] == 0


def test_a_sharded_solve_runs_no_step_kernel_slot():
    settings = PDLPSolverSettings()
    settings.operator_kind = "blockband"
    settings.iteration_limit = 40
    prob = generate_lp(1024, 1024, 6, seed=11, band=192)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    raw = T.PdlpSolver(prob, settings, "cpu", mesh=mesh).run()
    assert raw["graph_slots"] == raw["attempts"] >= 40
    assert raw["step_kernel_slots"] == 0


def _kernel_major(dev, s, cfg, work):
    """A major as a host loop of `kernel_slot`s, each writing the other
    of two states, until the major's steps are done: the driver's
    oracle on its step-kernel path."""
    s, out = _copy(s), _copy(s)
    pending, out_pending = (torch.zeros((), dtype=torch.int64)
                            for _ in (0, 1))
    steps0 = int(s.total_steps)
    while int(s.total_steps) - steps0 < cfg.hp.major_iteration:
        ps.kernel_slot(dev, s, pending, cfg, out, out_pending, work)
        s, out, pending, out_pending = out, s, out_pending, pending
    return T.major_tail(dev, s, cfg)


@pytest.mark.parametrize("dtype,fused_kernel", PATHS, ids=PATH_IDS)
def test_driver_counts_the_slots_it_runs_through_the_step_kernels(
        monkeypatch, dtype, fused_kernel):
    """With the step kernels selected (here on the CPU, so their plain
    versions), every slot of the driver runs them and counts as one of
    its `kernel_slots`; two majors equal, bit for bit, a host loop of
    `kernel_slot`s."""
    dev, cfg, s, work = _setup(dtype, fused_kernel, majors=0)
    monkeypatch.setattr(T, "_solo_on_card", lambda dev, s: True)
    driver = T.make_major_fn(cfg)
    driver._graphed = lambda dev, s: False  # nothing to capture on a CPU
    want = got = s
    for k in range(2):
        want, want_r = _kernel_major(dev, want, cfg, work)
        got, got_r = driver(dev, got)
        for f in dataclasses.fields(T.SolverState):
            assert torch.equal(getattr(want, f.name), getattr(got, f.name)), \
                (k, f.name)
        assert torch.equal(want_r["kkt_cur"], got_r["kkt_cur"])
    assert driver.work is not None
    assert driver.kernel_slots == driver.slots == int(got.total_attempts)
