"""cuopt_torch's CUDA kernels against their plain PyTorch versions, on a card.

Run on a machine with a CUDA card:

    python -m pytest -m gpu tests/test_torch_gpu.py -q

Without a card every test skips. Whether there is one is decided in the
`cuda` fixture, never while the module is imported, so every pytest worker
collects the same tests. The checks are those chip_smoke.py runs at the
main path's shapes (cuopt_torch/kernels/checks.py), here at small ones,
and the concurrent race and a warm re-solve run their PDLP through them.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import cuopt_torch.dual_simplex.concurrent as concurrent
from cuopt_torch import constants as C
from cuopt_torch.kernels.checks import (check_row_pass, check_step_kernels,
                                        row_pass_inputs)
from cuopt_torch.lp import pdhg_fused as pf
from cuopt_torch.lp import pdhg_step as ps
from cuopt_torch.lp import pdlp as TP
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.lp.solve import solve_lp
from cuopt_torch.problem.mittelmann import GENERATORS
from cuopt_torch.problem.synthetic import generate_lp
from cuopt_torch.sparse import build_operator, reorder
from cuopt_torch.sparse.ops import BlockBandOp, _BandSide
from cuopt_torch.sparse.reorder import permute_csr

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _op(case, device):
    """A float32 BlockBandOp on `device`: banded (W=256), the same matrix
    shuffled and reordered (with spill), degen-transport (W=4224), or one
    of WIDTH_CASES."""
    if case in WIDTH_CASES:
        return _op_of_width(*WIDTH_CASES[case], device)
    if case == "wide":
        p = GENERATORS["degen-transport"](2000, 0)
        offsets, indices, values = p.offsets, p.indices, p.values
        n_rows, n_cols, kind = p.n_constraints, p.n_variables, "bandperm"
    else:
        n_rows = n_cols = 3000
        p = generate_lp(n_rows, n_cols, 6, seed=5, band=96)
        offsets, indices, values = p.offsets, p.indices, p.values
        kind = "blockband"
        if case == "shuffled":
            rng = np.random.default_rng(9)
            offsets, indices, values = permute_csr(
                offsets, indices, np.asarray(values, np.float64),
                rng.permutation(n_rows), rng.permutation(n_cols), n_rows,
                n_cols)
            kind = "bandperm"
    op = build_operator(offsets, indices, values, n_rows, n_cols,
                        dtype=torch.float32, kind=kind, device=device)
    return getattr(op, "inner", op)


def _op_of_width(n, W, band, device):
    """A float32 BlockBandOp of generate_lp(n, n, 6, seed=5, band=band)
    whose row slabs have window width W exactly: the builder's choice of
    width is bypassed, entries outside the windows go to the spill. Only
    the row side is built; the row pass reads nothing else."""
    p = generate_lp(n, n, 6, seed=5, band=band)
    offsets, indices = np.asarray(p.offsets), np.asarray(p.indices)
    values = np.asarray(p.values, np.float32)
    rows = np.repeat(np.arange(n), np.diff(offsets))
    starts, inside = (a.numpy() for a in _BandSide(
        *map(torch.as_tensor, (rows, indices, values)), n, n, 128).windows(W))
    t_of = rows // 128
    slabs = np.zeros((-(-n // 128), 128, W), np.float32)
    np.add.at(slabs, (t_of[inside], rows[inside] % 128,
                      indices[inside] - starts[t_of[inside]]),
              values[inside])

    def t(a):
        return torch.as_tensor(a, device=device)

    none_f, none_i = t(np.zeros(0, np.float32)), t(np.zeros(0, np.int64))
    return BlockBandOp(
        n_rows=n, n_cols=n, tile=128, w_row=W, w_col=128,
        row_starts=tuple(int(s) for s in starts), col_starts=(0,),
        row_slabs=t(slabs), col_slabs=t(np.zeros((1, 128, 128), np.float32)),
        spill_vals=t(values[~inside]), spill_rows=t(rows[~inside]),
        spill_cols=t(indices[~inside].astype(np.int64)),
        t_spill_vals=none_f, t_spill_rows=none_i, t_spill_cols=none_i)


# (n, W, band): both sides of each width limit (one-pass up to 1024,
# column-split up to 8192 with a ragged last float4 column group at 1152,
# two-read above), and a tile count (397) that is no multiple of the
# card's resident blocks (3 x 132) or of the ring's stages, with a ragged
# last tile. "wide" (degen-transport, W=4224) is the main path's width.
WIDTH_CASES = {
    "w-one-pass": (3000, pf.W_ONE_PASS, 900),
    "w-1152": (3000, pf.W_ONE_PASS + 128, 900),
    "w-2048": (3000, 2048, 900),
    "w-column-split": (3000, pf.W_COLUMN_SPLIT, 900),
    "w-two-read": (3000, pf.W_COLUMN_SPLIT + 128, 900),
    "ragged-397-tiles": (397 * 128 - 37, 384, 256),
}


@pytest.mark.parametrize("mode", ["atomic", "partials"])
@pytest.mark.parametrize("case", ["banded", "shuffled", "wide",
                                  *WIDTH_CASES])
def test_kernel_matches_plain(cuda, case, mode):
    op = _op(case, cuda)
    assert pf.fused_pass_supported(op, torch.float32)
    assert pf.kernel_config(op.w_row, mode)["variant"] == \
        pf.body_of_width(op.w_row)
    pf.reset_counts()
    out = check_row_pass(op, mode, row_pass_inputs(op, seed=3))
    assert out["ok"], out
    kernel = pf.ROW_PASS_ATOMIC if mode == "atomic" else pf.ROW_PASS_PARTIALS
    assert kernel.launches >= 1 and pf.PlainCount.calls == 0
    if mode == "partials":
        # same bits twice, and A^T y exactly its parts in the plan's order
        assert out["deterministic"] and out["folded_exact"]
        assert pf.plan(op).counters.eq(0).all()  # reset for the next launch


@pytest.mark.parametrize("mode", ["atomic", "partials"])
def test_kernel_in_a_cuda_graph(cuda, mode):
    """The launch replays in a CUDA graph: no host-side state, and the
    partials mode's counters are back to zero after every launch. The
    kernel counts the launches that ran: each eager one and each replay,
    never the capture."""
    op = _op("wide", cuda)
    assert op.w_row == 4224  # the main path's widest window
    kernel = pf.ROW_PASS_ATOMIC if mode == "atomic" else pf.ROW_PASS_PARTIALS
    inputs = row_pass_inputs(op, seed=4)
    pf.reset_counts()
    want = pf.row_pass_kernel(op, *inputs, mode)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pf.row_pass_kernel(op, *inputs, mode)
    torch.cuda.current_stream().wait_stream(side)
    assert kernel.launches == 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pf.row_pass_kernel(op, *inputs, mode)
    assert kernel.launches == 2
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert kernel.launches == 5
    for a, b in zip(got, want):
        if mode == "partials":
            assert torch.equal(a, b)
        else:
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    op = _op("banded", cuda)
    x, ax_old, ax_spill, y, lc, uc, sigma = row_pass_inputs(op)
    with pytest.raises(ValueError, match="float32"):
        pf.row_pass(op, x.double(), ax_old, ax_spill, y, lc, uc, sigma)
    with pytest.raises(ValueError, match="shape"):
        pf.row_pass(op, x[:-1], ax_old, ax_spill, y, lc, uc, sigma)


def test_f32_solve_runs_every_attempt_through_the_kernel(cuda):
    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.dtype = "float32"
    s.method = C.CUOPT_METHOD_PDLP  # the default races a host simplex
    pf.reset_counts()
    ps.reset_counts()
    sol = solve_lp(prob, s, device=cuda)
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert pf.ROW_PASS_ATOMIC.launches == info["attempts"] > 0
    assert pf.PlainCount.calls == 0
    # every attempt a slot of the graph driver, a few count reads a major
    assert info["graph_slots"] == info["attempts"]
    assert 0 < info["graph_count_reads"] < info["attempts"]
    # every slot through the step kernels, the fused path's three
    assert info["step_kernel_slots"] == info["graph_slots"]
    assert [k.launches for k in ps.KERNELS] == [
        info["attempts"], 0, info["attempts"], info["attempts"]]
    ref = PDLPSolverSettings()
    ref.log_to_console = False
    ref.method = C.CUOPT_METHOD_PDLP
    want = solve_lp(prob, ref, device="cpu").get_primal_objective()
    got = sol.get_primal_objective()
    assert abs(got - want) <= 1e-3 * (1 + abs(want)), (got, want)


def test_f64_solve_runs_every_slot_through_the_step_kernels(cuda):
    """A float64 solve (the surfaces' default) on the unfused pair: every
    slot runs pdhg_primal, pdhg_dual and pdhg_commit, and no row pass."""
    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    pf.reset_counts()
    ps.reset_counts()
    sol = solve_lp(prob, _f32_pdlp_settings(dtype="float64"), device=cuda)
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert info["step_kernel_slots"] == info["graph_slots"] == \
        info["attempts"] > 0
    assert [k.launches for k in ps.KERNELS] == [
        info["attempts"], info["attempts"], 0, info["attempts"]]
    assert all(k.launches == 0 for k in pf.KERNELS)


@pytest.mark.parametrize("dtype, kind, fused_kernel, n", [
    (torch.float32, "blockband", "auto", 3000),
    (torch.float32, "blockband", "off", 3000),
    (torch.float64, "blockband", "auto", 3000),
    (torch.float64, "csr", "auto", 3000),
    # past MAX_PARTS * CHUNK columns: 256 partial sums a vector
    (torch.float32, "blockband", "auto", 270_000)])
def test_step_kernels_match_their_plain_versions(cuda, dtype, kind,
                                                 fused_kernel, n):
    """Each step kernel against its plain version on the state after a
    major, and the slot through them against the plain slot
    (`kernels/checks.py check_step_kernels`)."""
    prob = generate_lp(n, n, 6, seed=11, band=96)
    solver = TP.PdlpSolver(prob, _f32_pdlp_settings(), device=cuda)
    cfg = dataclasses.replace(solver.cfg, fused_kernel=fused_kernel)
    dev = TP.build_device_problem(prob, solver.hp, dtype, kind, cuda)
    fused = TP._use_fused(dev, dtype, cfg)
    assert fused == (dtype == torch.float32 and fused_kernel == "auto")
    s, _ = TP.make_major_fn(cfg)(dev, TP.initial_state(dev, solver.hp,
                                                       dtype))
    if n > ps.MAX_PARTS * ps.CHUNK:
        assert ps.step_work(dev, s, fused).bx == ps.MAX_PARTS
    result = check_step_kernels(dev, s, cfg, fused)
    assert result["ok"], result


def test_step_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    solver = TP.PdlpSolver(prob, _f32_pdlp_settings(), device=cuda)
    dev = TP.build_device_problem(prob, solver.hp, torch.float32,
                                  "blockband", cuda)
    s = TP.initial_state(dev, solver.hp, torch.float32)
    work = ps.step_work(dev, s, False)
    with pytest.raises(ValueError, match="aty must be"):
        ps.primal(dev, s.replace(aty=s.aty.double()), work)
    with pytest.raises(ValueError, match="y_new must be"):
        ps.row_sums(s, s.ax, s.y[:-1], work)


def _eager_driver(cfg):
    """A step driver whose slots run eagerly on the card too."""
    driver = TP.make_major_fn(cfg)
    driver._graphed = lambda dev, s: False
    return driver


@pytest.mark.parametrize("dtype, kind", [
    (torch.float32, "blockband"), (torch.float64, "blockband"),
    (torch.float64, "csr")])
def test_graph_driver_equals_eager_majors_on_the_card(cuda, monkeypatch,
                                                      dtype, kind):
    """The step driver's CUDA-graph replays against the same driver with
    every slot run eagerly, three majors from one state on the card:
    every state field equal, bit for bit. float32 runs the fused row pass
    in its partials mode, whose Aᵀy sums in a fixed order (the atomic
    mode adds in no fixed order, so two eager runs differ too). CsrOp's
    segment sums are index_add, which adds with atomics on a card, so its
    case runs under torch's deterministic algorithms, where index_add
    sums in a sorted order."""
    monkeypatch.setattr(pf, "PARTIALS_MIN_COLS", 0)
    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    solver = TP.PdlpSolver(prob, _f32_pdlp_settings(), device=cuda)
    dev = TP.build_device_problem(prob, solver.hp, dtype, kind, cuda)
    # both drivers run the step kernels, the eager one outside any graph
    assert type(dev.op).__name__ == \
        ("CsrOp" if kind == "csr" else "BlockBandOp")
    fused = TP._use_fused(dev, dtype, solver.cfg)
    assert fused == (dtype == torch.float32)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(kind == "csr")
    try:
        eager_s = graph_s = TP.initial_state(dev, solver.hp, dtype)
        eager, driver = _eager_driver(solver.cfg), TP.make_major_fn(solver.cfg)
        for k in range(3):
            eager_s, _ = eager(dev, eager_s)
            pf.reset_counts()
            ps.reset_counts()
            graph_s, _ = driver(dev, graph_s)
            launches = pf.ROW_PASS_PARTIALS.launches
            step_launches = [k.launches for k in ps.KERNELS]
            for f in dataclasses.fields(TP.SolverState):
                assert torch.equal(getattr(eager_s, f.name),
                                   getattr(graph_s, f.name)), (k, f.name)
            if k == 0:
                attempts0 = int(graph_s.total_attempts)
                assert launches == (attempts0 if fused else 0)
                assert step_launches == [
                    attempts0, 0 if fused else attempts0,
                    attempts0 if fused else 0, attempts0]
        assert eager.graphs is None and driver.graphs is not None
        assert driver.slots == eager.slots == int(graph_s.total_attempts)
        assert driver.kernel_slots == eager.kernel_slots == driver.slots
        assert driver.count_reads == eager.count_reads
        assert int(graph_s.total_attempts) > int(graph_s.total_steps)
        if fused:  # the partials kernel left its arrival counts at 0
            assert pf.plan(dev.op).counters.eq(0).all()
    finally:
        torch.use_deterministic_algorithms(was)


def test_graph_driver_recaptures_for_a_second_problem(cuda):
    """A driver handed another problem captures new graphs for it and
    gives that problem's majors: a 3k staircase, a 2k one, then the 3k
    one again, each major equal bit for bit to a new driver's whose slots
    run eagerly. They run in float64 on the block band: the fused
    row pass's atomic mode sums Aᵀy in no fixed order."""
    probs = [generate_lp(3000, 3000, 6, seed=11, band=96),
             generate_lp(2048, 2048, 6, seed=3, band=96)]
    solver = TP.PdlpSolver(probs[0], _f32_pdlp_settings(), device=cuda)
    devs = [TP.build_device_problem(p, solver.hp, torch.float64,
                                    "blockband", cuda) for p in probs]
    driver = TP.make_major_fn(solver.cfg)
    seen = []
    for k, dev in enumerate((devs[0], devs[1], devs[0])):
        s0 = TP.initial_state(dev, solver.hp, torch.float64)
        want, _ = _eager_driver(solver.cfg)(dev, s0)
        got, _ = driver(dev, s0)
        assert driver.dev is dev and driver.graphs is not None
        assert all(g is not driver.graphs for g in seen), k
        seen.append(driver.graphs)
        for f in dataclasses.fields(TP.SolverState):
            assert torch.equal(getattr(want, f.name),
                               getattr(got, f.name)), (k, f.name)


def test_capture_beside_a_thread_replaying_its_graph(cuda):
    """The MIP's pattern: FJ's thread replays its CUDA graphs on a stream
    of its own while a PDLP solve, in another thread, captures its
    slots (thread-local capture mode). Both go on, and the solve runs
    every attempt through the graph driver."""
    stop, errors, replays = threading.Event(), [], [0]

    def replaying():
        try:
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                v = torch.zeros(1 << 16, device=cuda)
                v.add_(1.0)
                g = torch.cuda.CUDAGraph()
                g.capture_begin(capture_error_mode="thread_local")
                v.add_(1.0)
                g.capture_end()
                while not stop.is_set():
                    g.replay()
                    replays[0] += 1
                    time.sleep(0)
                side.synchronize()
            assert float(v[0]) == replays[0] + 1
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    t = threading.Thread(target=replaying)
    t.start()
    try:
        while not replays[0] and t.is_alive():
            time.sleep(0.001)
        prob = generate_lp(3000, 3000, 6, seed=11, band=96)
        sol = solve_lp(prob, _f32_pdlp_settings(), device=cuda)
        seen = replays[0]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert info["graph_slots"] == info["attempts"] > 0
    assert seen > 0


def test_solves_leave_no_memory_behind(cuda):
    """Every solve captures its graphs on this thread's one capture
    stream: a new stream per solve would keep a cuBLAS workspace (32 MiB
    on an H100) each time, until torch's pool of 32 streams wraps."""
    def solve(seed):
        prob = generate_lp(3000, 3000, 6, seed=seed, band=96)
        sol = solve_lp(prob, _f32_pdlp_settings(), device=cuda)
        assert sol.get_termination_reason() == "Optimal"

    solve(1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    for seed in (2, 3, 4):
        solve(seed)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before < 1 << 20
    assert len(TP._CAPTURE.streams) == 1


def test_profiled_solve_traces_a_row_pass_an_attempt(cuda):
    """Under torch.profiler the captured and replayed solve still shows
    one row-pass kernel an attempt on the device (the benchmark's
    row_pass_roofline counts them by name), one capture span, and at most
    four step-count reads a major."""
    from torch.autograd import DeviceType

    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sol = solve_lp(prob, _f32_pdlp_settings(), device=cuda)
        torch.cuda.synchronize()
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    events = prof.events()
    passes = [e for e in events if e.device_type == DeviceType.CUDA
              and "row_pass_one_pass" in e.name]
    assert len(passes) == info["attempts"] > 0
    names = [e.name for e in events if e.device_type == DeviceType.CPU]
    majors = names.count("pdlp_major_readback")
    assert majors >= 1
    assert names.count("pdlp_graph_capture") == 1
    assert names.count("pdlp_step_sync") <= 4 * majors
    assert names.count("pdlp_step_sync") == info["graph_count_reads"]


def _f32_pdlp_settings(**kw):
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.dtype = "float32"
    s.method = C.CUOPT_METHOD_PDLP
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def test_band_recovery_on_the_card_equals_the_cpus(cuda, monkeypatch):
    """The 50k staircase under a random row and column permutation (the
    shuffled benchmark cell's LP): the permutation computed on the card
    equals the CPU's bit for bit (the CPU's equals cuopt_tpu's,
    tests/test_torch_reorder.py), and a float32 solve on the card takes
    the same steps whether its permutation came from the card or from
    the CPU. Both solves run the partials row pass, which sums Aᵀy in a
    fixed order: the atomic one adds in float32 in no fixed order, so
    its step counts can differ between two solves of one LP."""
    n = 50_000
    base = generate_lp(n, n, 8, seed=17, band=256)
    rng = np.random.default_rng(18)
    rp, cp = rng.permutation(n), rng.permutation(n)
    offsets, indices, values = permute_csr(
        base.offsets, base.indices, np.asarray(base.values, np.float64),
        rp, cp, n, n)
    prob = dataclasses.replace(
        base, offsets=offsets, indices=indices, values=values,
        constraint_lower_bounds=base.constraint_lower_bounds[rp],
        constraint_upper_bounds=base.constraint_upper_bounds[rp],
        objective_coefficients=base.objective_coefficients[cp],
        variable_lower_bounds=base.variable_lower_bounds[cp],
        variable_upper_bounds=base.variable_upper_bounds[cp])
    args = (offsets, indices, n, n)
    on_card = reorder.bandwidth_permutation(*args, device=cuda)
    on_cpu = reorder.bandwidth_permutation(*args, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu))
    assert not np.array_equal(on_card[0], np.arange(n))

    def steps(p):
        sol = solve_lp(p, _f32_pdlp_settings(), device=cuda)
        assert sol.get_termination_reason() == "Optimal"
        return sol.get_additional_termination_information()["iterations"]

    monkeypatch.setattr(pf, "PARTIALS_MIN_COLS", 0)
    card_steps = steps(dataclasses.replace(prob))
    real = reorder.bandwidth_permutation
    monkeypatch.setattr(reorder, "bandwidth_permutation",
                        lambda *a, **k: real(*a, **{**k, "device": "cpu"}))
    assert steps(dataclasses.replace(prob)) == card_steps


def _with_repeats(offsets, indices, values):
    """The CSR with every 7th row's first entry repeated once, after its
    third, and every 11th row's last entry twice more, after its first
    and at its end: (row, column)s two and three deep, the copies among
    the row's other entries, each copy with a value of its own."""
    rng = np.random.default_rng(23)
    rows = []
    for i in range(len(offsets) - 1):
        a, b = int(offsets[i]), int(offsets[i + 1])
        r = list(zip(indices[a:b], values[a:b]))
        if i % 7 == 0 and r:
            r.insert(3, (r[0][0], rng.normal()))
        if i % 11 == 0 and r:
            r.insert(1, (r[-1][0], rng.normal()))
            r.append((r[-1][0], rng.normal()))
        rows.append(r)
    out = [np.concatenate([[0], np.cumsum([len(r) for r in rows])])]
    for k in (0, 1):
        out.append(np.array([e[k] for r in rows for e in r]))
    return out


@pytest.mark.parametrize("case,dtype", [
    ("staircase-20k", torch.float32), ("shuffled-20k", torch.float32),
    ("repeats-20k", torch.float32), ("repeats-20k", torch.float64)])
def test_band_layout_on_the_card_equals_the_cpus(cuda, case, dtype):
    """The block band laid out on the card equals the one laid out on
    the CPU bit for bit (the CPU's equals cuopt_tpu's NumPy layout,
    tests/test_torch_problem_sparse.py): slabs, starts, widths and both
    spills. The 20k staircase; the same LP under a random row and column
    shuffle, whose band bandwidth_permutation recovers; and the staircase
    with repeated (row, column)s, which the layout sums in CSR order."""
    n = 20_000
    p = generate_lp(n, n, 8, seed=29, band=256)
    offsets, indices, values = p.offsets, p.indices, p.values
    kind = "blockband"
    if case == "shuffled-20k":
        rng = np.random.default_rng(30)
        offsets, indices, values = permute_csr(
            offsets, indices, np.asarray(values, np.float64),
            rng.permutation(n), rng.permutation(n), n, n)
        kind = "bandperm"
    if case == "repeats-20k":
        offsets, indices, values = _with_repeats(offsets, indices, values)
    card, cpu = (build_operator(offsets, indices, values, n, n, dtype=dtype,
                                kind=kind, device=d) for d in (cuda, "cpu"))
    if kind == "bandperm":
        for f in ("row_perm", "col_perm"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
        card, cpu = card.inner, cpu.inner
    assert card.row_slabs.device.type == "cuda"
    for f in dataclasses.fields(BlockBandOp):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a.cpu().numpy().view(np.uint8),
                                  b.numpy().view(np.uint8)), f.name
        else:
            assert a == b, f.name
    if case == "repeats-20k":
        assert card.spill_vals.numel() < len(values)


def test_race_against_a_blocked_simplex_on_the_card(cuda, monkeypatch):
    """The concurrent race with a simplex leg that blocks until halted:
    PDLP wins on the card, every attempt through the kernel, and the
    simplex thread is halted and joined."""
    seen = {}

    def blocked(prob, settings, timer, halt=None, **kw):
        seen["thread"] = threading.current_thread()
        while not halt.contents.value:
            time.sleep(0.001)
        return {"status": C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT,
                "iterations": 0}

    monkeypatch.setattr(concurrent, "solve_lp_simplex", blocked)
    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    s = _f32_pdlp_settings(method=C.CUOPT_METHOD_CONCURRENT, time_limit=5.0)
    pf.reset_counts()
    sol = solve_lp(prob, s, device=cuda)
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert info["solved_by"] == "pdlp"
    assert pf.ROW_PASS_ATOMIC.launches == info["attempts"] > 0
    assert pf.PlainCount.calls == 0
    assert info["race"]["simplex_status"] == \
        C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
    assert not seen["thread"].is_alive()


def test_warm_resolve_runs_every_attempt_through_the_kernel(cuda):
    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    first = solve_lp(prob, _f32_pdlp_settings(), device=cuda)
    ws = first.get_pdlp_warm_start_data()
    moved = dataclasses.replace(
        prob, objective_coefficients=prob.objective_coefficients * 1.001)
    pf.reset_counts()
    warm = solve_lp(moved, _f32_pdlp_settings(warm_start_data=ws),
                    device=cuda)
    info = warm.get_additional_termination_information()
    assert warm.get_termination_reason() == "Optimal"
    assert pf.ROW_PASS_ATOMIC.launches == \
        info["attempts"] - ws.total_pdhg_iterations > 0
    assert pf.PlainCount.calls == 0
    cold = solve_lp(moved, _f32_pdlp_settings(), device=cuda)
    a, b = warm.get_primal_objective(), cold.get_primal_objective()
    assert abs(a - b) <= 1e-3 * (1 + abs(b)), (a, b)
    assert info["iterations"] - ws.total_pdlp_iterations < \
        cold.get_nb_iterations()


# ----------------------------------------------- batch LP and MIP on the card
def test_batched_block_band_matches_single_operators(cuda):
    """The stacked block-band operator of lp/batch.py (one sparsity
    pattern, per-member values, shared window starts) under vmap gives
    each member's matvec and rmatvec of its own operator, with spill."""
    from torch.func import vmap

    from cuopt_torch.lp import batch as TB

    n = 3000
    base = generate_lp(n, n, 6, seed=5, band=96)
    rng = np.random.default_rng(0)
    # one far entry in every 50th row: outside its tile's window (spill)
    rows = np.repeat(np.arange(n), np.diff(base.offsets))
    far = np.arange(0, n, 50)
    order = np.argsort(np.concatenate([rows, far]), kind="stable")
    cols = np.concatenate([base.indices, (far + n // 2) % n])[order]
    vals = np.concatenate([base.values, rng.normal(size=len(far))])[order]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(
        np.concatenate([rows, far]), minlength=n))])
    ops = [build_operator(offsets, cols, vals * rng.uniform(0.5, 1.5,
                                                            len(vals)),
                          n, n, dtype=torch.float64, kind="blockband",
                          device=cuda) for _ in range(4)]
    assert all(o.row_starts == ops[0].row_starts for o in ops)
    assert ops[0].spill_vals.numel() and ops[0].t_spill_vals.numel()
    leaves = TB._stack(ops)
    x = torch.randn(4, n, dtype=torch.float64, device=cuda)
    y = torch.randn(4, n, dtype=torch.float64, device=cuda)

    def mv(lv, v):
        return TB._join(ops[0], lv).matvec(v)

    def rmv(lv, v):
        return TB._join(ops[0], lv).rmatvec(v)

    ax, aty = vmap(mv)(leaves, x), vmap(rmv)(leaves, y)
    for b, op in enumerate(ops):
        torch.testing.assert_close(ax[b], op.matvec(x[b]), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(aty[b], op.rmatvec(y[b]), rtol=1e-12,
                                   atol=1e-12)


def test_batch_solve_on_card(cuda):
    from cuopt_torch.lp.batch import batch_solve

    base = generate_lp(2000, 2000, 6, seed=3, band=96)
    rng = np.random.default_rng(0)
    probs = [dataclasses.replace(
        base, constraint_upper_bounds=base.constraint_upper_bounds
        + rng.uniform(0, 0.5, base.n_constraints)) for _ in range(4)]
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.method = C.CUOPT_METHOD_PDLP
    sols = batch_solve(probs, s)
    for p, sol in zip(probs, sols):
        assert sol._raw["solved_by"] == "pdlp_batch"
        solo = solve_lp(dataclasses.replace(p), s)
        assert sol.get_termination_reason() == "Optimal"
        a, b = sol.get_primal_objective(), solo.get_primal_objective()
        assert abs(a - b) <= 1e-3 * abs(b)


def test_fj_blocked_scoring_equals_unblocked_on_card(cuda):
    """Blocked candidate scoring on the card gives the bits of one block
    over every variable, and a chunk stepped either way the same state."""
    from cuopt_torch.mip import feasibility_jump as F

    p = generate_lp(2000, 2000, 8, seed=123, band=256)
    rng = np.random.default_rng(0)
    p.variable_types[rng.choice(2000, 600, replace=False)] = "I"
    fp = F.make_fj_problem(p, device=cuda)
    s0 = F.init_state(fp, rng.uniform(0, 1, (9, 2000)), [1e-3] * 9)
    block = F.score_block_size(fp, 9, cap_bytes=1 << 20)
    assert block < 2000
    whole = F.score_block(fp, s0, 0, 2000)
    parts = [F.score_block(fp, s0, j, min(j + block, 2000))
             for j in range(0, 2000, block)]
    for k in range(2):
        assert torch.equal(whole[k], torch.cat([q[k] for q in parts], 1))
    a = F.fj_chunk(fp, s0, 16, block=2000)
    b = F.fj_chunk(fp, s0, 16, block=block)
    for f in dataclasses.fields(F.FjState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_fj_chunk_rescoring_equals_full_rescoring_on_card(cuda):
    """On the card, a chunk that rescores only what each step changed,
    replaying the step's CUDA graph, gives the bits of rescoring every
    variable at every step (chunks of one step); a second chunk reuses
    the graph."""
    from cuopt_torch.mip import feasibility_jump as F

    p = generate_lp(2000, 2000, 8, seed=123, band=256)
    rng = np.random.default_rng(1)
    p.variable_types[rng.choice(2000, 600, replace=False)] = "I"
    fp = F.make_fj_problem(p, device=cuda)
    s0 = F.init_state(fp, rng.uniform(0, 1, (9, 2000)),
                      [1e-3, 1e-2, 1e-4, 0.0] * 2 + [1e-3])
    stats = {}
    a = F.fj_chunk(fp, s0, 32, stats=stats)
    a = F.fj_chunk(fp, a, 32, stats=stats)
    b = s0
    for _ in range(64):
        b = F.fj_chunk(fp, b, 1)
    for f in dataclasses.fields(F.FjState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert stats["full_rescores"] < 64 * 9
    assert list(fp._step_graphs) == [9]


def test_solve_mip_on_card(cuda):
    """A small mixed MIP by solve_mip on the card: the FJ thread steps its
    climbers on a stream of its own and records no error."""
    from cuopt_torch.lp.settings import MIPSolverSettings
    from cuopt_torch.mip.solve import solve_mip

    p = generate_lp(300, 300, 8, seed=123, band=256)
    rng = np.random.default_rng(0)
    is_int = np.zeros(300, bool)
    is_int[rng.choice(300, 90, replace=False)] = True
    x_hat = np.where(is_int, rng.integers(0, 2, 300), rng.uniform(0.2, 0.8,
                                                                 300))
    ub = p.to_dense() @ x_hat + rng.uniform(0.1, 1.0, 300)
    p = dataclasses.replace(
        p, variable_types=np.where(is_int, "I", "C").astype("U1"),
        constraint_upper_bounds=ub, rhs=ub.copy())
    s = MIPSolverSettings()
    s.time_limit = 20.0
    s.log_to_console = False
    sol = solve_mip(p, s)
    assert sol.get_termination_reason() in ("Optimal", "FeasibleFound")
    assert sol._raw["heuristic_errors"] == []
    assert sol._raw["fj"]["device"].startswith("cuda")
    assert sol.get_primal_objective() <= float(
        p.objective_coefficients @ x_hat) + 1e-6


def test_routing_evaluators_on_card(cuda):
    """The routing move evaluators on the card against the port on the
    CPU, from the same routes: the tiled (vmapped) evaluation and the
    insertion scores, deltas within rtol 1e-5 / atol 1e-3."""
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing.construction import batched_construction
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.solver import (
        _grouped_moves,
        _pad_len,
        _routes_to_arrays,
    )

    prob = build_problem(synth_gh_instance(200, "RC", seed=2)
                         .to_data_model())
    gpu = ls.build_ls_problem(prob, device=cuda)
    cpu = ls.build_ls_problem(prob, device="cpu")
    routes, _ = batched_construction(prob, cpu)
    R, lens = _routes_to_arrays(prob, routes, _pad_len(routes, headroom=12))
    a = _grouped_moves(prob, gpu, R, lens, 0, group=8)
    b = _grouped_moves(prob, cpu, R, lens, 0, group=8)
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-5, atol=1e-3)
    cand = np.arange(0, prob.n_serve, 7)
    x = ls.to_host(ls.evaluate_insertions(gpu, R, lens, cand))
    y = ls.to_host(ls.evaluate_insertions(cpu, R, lens, cand))
    assert np.array_equal(x >= ls.BIG / 2, y >= ls.BIG / 2)
    np.testing.assert_allclose(x[x < ls.BIG / 2], y[y < ls.BIG / 2],
                               rtol=1e-5, atol=1e-3)


def test_pd_move_scores_on_card(cuda):
    """The carried-load path of the move evaluators (pickup-delivery
    pairs: peaks by cummax, the 2-opt range minimum, the pair relocate)
    on the card against the port on the CPU, from the same feasible
    routes: the five score tensors, the insertion scores and the tiled
    evaluation, masks equal and deltas within rtol 1e-5 / atol 1e-3."""
    import cuopt_torch.io.vrp as vrp
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing.construction import cheapest_insertion
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.solver import (
        _grouped_moves,
        _pad_len,
        _routes_to_arrays,
    )
    from torch_routing_instances import pd_mixed

    prob = pd_mixed(vrp, build_problem, seed=0)
    gpu = ls.build_ls_problem(prob, device=cuda)
    cpu = ls.build_ls_problem(prob, device="cpu")
    assert gpu.has_pairs
    routes, _ = cheapest_insertion(prob, rng=np.random.default_rng(0),
                                   noise=0.5)
    R, lens = _routes_to_arrays(prob, routes, _pad_len(routes, headroom=4))

    def close(x, y):
        x, y = ls.to_host(x), ls.to_host(y)
        assert np.array_equal(x >= ls.BIG / 2, y >= ls.BIG / 2)
        np.testing.assert_allclose(x[x < ls.BIG / 2], y[y < ls.BIG / 2],
                                   rtol=1e-5, atol=1e-3)

    for x, y in zip(ls._move_scores(gpu, ls._ids(gpu, R),
                                    ls._ids(gpu, lens)),
                    ls._move_scores(cpu, ls._ids(cpu, R),
                                    ls._ids(cpu, lens))):
        close(x, y)
    cand = np.arange(0, prob.n_serve, 2)
    close(ls.evaluate_insertions(gpu, R, lens, cand),
          ls.evaluate_insertions(cpu, R, lens, cand))
    a = _grouped_moves(prob, gpu, R, lens, 0, group=4)
    b = _grouped_moves(prob, cpu, R, lens, 0, group=4)
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-5, atol=1e-3)


def test_routing_solve_on_card(cuda):
    """Solve on its default device, the card: every order served once."""
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing import Solve, SolverSettings

    inst = synth_gh_instance(60, "C", seed=4)
    s = SolverSettings()
    s.set_time_limit(3.0)
    sol = Solve(inst.to_data_model(), s)
    assert sol.get_status() == 0, sol.get_message()
    table = sol.get_route()
    served = table[table["type"] == "Delivery"]["route"]
    assert np.array_equal(np.sort(served), np.arange(60))


def test_facade_solve_on_card(cuda):
    """linear_programming.Solve with registry settings and its default
    device, the card: every attempt through the row-pass kernel."""
    from cuopt_torch.linear_programming import Solve, SolverSettings

    prob = generate_lp(3000, 3000, 6, seed=11, band=96)
    s = SolverSettings()
    s.set_parameter("method", C.CUOPT_METHOD_PDLP)
    s.set_parameter("log_to_console", "false")
    s.pdlp.dtype = "float32"
    pf.reset_counts()
    sol = Solve(prob, s)
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert pf.ROW_PASS_ATOMIC.launches == info["attempts"] > 0


def test_server_request_on_card(cuda, tmp_path):
    """One LP through the service, solved by a worker on cuda:0."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    env.pop("CUOPT_TORCH_DEVICE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuopt_torch.server", "-p", str(port),
         "-i", "127.0.0.1", "-d", "1"], cwd=root, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        end = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(base + "/cuopt/health", timeout=5)
                break
            except OSError:
                assert time.monotonic() < end, "the server did not start"
                time.sleep(0.2)
        payload = {
            "csr_constraint_matrix": {"offsets": [0, 2, 4],
                                      "indices": [0, 1, 0, 1],
                                      "values": [3.0, 4.0, 2.7, 10.1]},
            "objective_data": {"coefficients": [-0.2, -0.1]},
            "constraint_bounds": {"upper_bounds": [5.4, 4.9],
                                  "lower_bounds": ["ninf", "ninf"]},
            "solver_config": {"method": 1},
        }
        req = urllib.request.Request(
            base + "/cuopt/request", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            req_id = json.load(r)["reqId"]
        end = time.monotonic() + 120
        while True:
            with urllib.request.urlopen(
                    f"{base}/cuopt/solution/{req_id}", timeout=30) as r:
                if r.status == 200:
                    out = json.load(r)["response"]["solver_response"]
                    break
            assert time.monotonic() < end, "no answer in 120 s"
            time.sleep(0.2)
        assert out["solution"]["termination_reason"] == "Optimal"
        assert abs(out["solution"]["primal_objective"] + 0.36) < 1e-3
    finally:
        proc.terminate()
        proc.wait(timeout=60)


@pytest.mark.parametrize("n", [2048, 2000])
def test_four_shards_on_one_card_match_the_unsharded_major(cuda, n):
    """Two float64 majors on four shards of the card (each on its own
    stream) against two unsharded majors from one state: x and y within
    1e-9, equal steps, no row-pass launch. n = 2048 takes the halo path,
    n = 2000 (a ragged last tile) the all-gather one."""
    from cuopt_torch.lp import pdlp
    from cuopt_torch.parallel import (gather_state, make_mesh,
                                      shard_problem_and_state)

    prob = generate_lp(n, n, 6, seed=3, band=192)
    s = PDLPSolverSettings()
    solver = pdlp.PdlpSolver(prob, s, cuda)
    dev = pdlp.build_device_problem(prob, solver.hp, torch.float64,
                                    "blockband", cuda)
    st0 = pdlp.initial_state(dev, solver.hp, torch.float64)
    fn = pdlp.make_major_fn(solver.cfg)
    s1, _ = fn(dev, st0)
    s1, _ = fn(dev, s1)
    sdev, sst = shard_problem_and_state(
        dev, st0, make_mesh(devices=[cuda] * 4))
    assert (sdev.shards[0].op.halo_meta is not None) == (n == 2048)
    pf.reset_counts()
    ps.reset_counts()
    kernel_slots = fn.kernel_slots
    sst, _ = fn(sdev, sst)
    sst, _ = fn(sdev, sst)
    assert all(k.launches == 0 for k in pf.KERNELS)
    # the shards run the torch slot, whose sums go through the collectives
    assert all(k.launches == 0 for k in ps.KERNELS)
    assert fn.kernel_slots == kernel_slots > 0
    g = gather_state(sst)
    assert int(g.total_steps) == int(s1.total_steps)
    for a, b in ((g.x, s1.x), (g.y, s1.y)):
        assert float(((a - b).abs() / (1 + b.abs())).max()) <= 1e-9


def test_island_epoch_on_four_shards_of_the_card(cuda):
    """One island epoch on four shards of the card equals its one-device
    simulation, route for route."""
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.parallel import make_mesh
    from cuopt_torch.routing.construction import cheapest_insertion
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.islands import (island_epoch,
                                             make_island_members,
                                             simulate_epoch)
    from cuopt_torch.routing.local_search import build_ls_problem

    prob = build_problem(synth_gh_instance(40, "C", seed=3).to_data_model())
    routes, _ = cheapest_insertion(prob)
    F = prob.n_fleet
    L = max(len(r) for r in routes.values()) + 4
    R0 = -np.ones((F, L), np.int64)
    lens0 = np.zeros(F, np.int64)
    for v, r in routes.items():
        R0[v, :len(r)] = r
        lens0[v] = len(r)
    p = build_ls_problem(prob, device=cuda)
    Rs, lenss = make_island_members(prob, R0, lens0, 8)
    Rw, lw, cw, _ = simulate_epoch(p, Rs, lenss, 4, 5)
    R4, l4, c4, _ = island_epoch(p, torch.as_tensor(Rs, device=cuda),
                                 torch.as_tensor(lenss, device=cuda),
                                 make_mesh(devices=[cuda] * 4), n_steps=5)
    assert np.array_equal(R4.cpu().numpy(), Rw)
    assert np.array_equal(l4.cpu().numpy(), lw)
    np.testing.assert_allclose(c4.cpu().numpy(), cw, rtol=1e-5)
