"""Feasibility Jump: weighted-violation hill climbers for MIP, on torch
tensors.

Counterpart of cuopt_tpu/mip/feasibility_jump.py, which re-designs the
reference FJ engine (cpp/src/mip/feasibility_jump/feasibility_jump.cuh
`fj_t`: load-balanced move evaluation kernels, several parallel
"climbers"):

  - move candidates for EVERY variable are scored by tensor ops built
    from the ELL adjacency of A^T;
  - independent climbers (different starts and objective weights) are a
    leading batch axis of every state tensor;
  - `fj_chunk` runs a fixed number of steps: the move-or-bump decision is
    a torch.where over both outcomes, and moves are scatters.

The scores pass through (climbers, variables, Lc, K) tensors (Lc = the
widest column, K = 3 Lc + 2 candidates). XLA fuses them; eager torch
materialises each one, so the scoring runs over blocks of variables sized
to keep every such intermediate under a cap (`_SCORE_BYTES`). Every sum in
the score runs over Lc within one variable, so blocking changes no bit,
and neither does rescoring only the variables a step changed: cuopt_tpu
rescores every variable at every step, `fj_chunk` does so once a chunk
and then only where a step bumped weights or moved the activities of a
variable's rows. On the 50k staircase MIP that is about 170 variables of
50,000 after most steps.

Algorithm (Luteberget-style FJ): keep per-constraint weights w; each step
move the variable/value with the best weighted-violation decrease
(breakpoint candidates per incident row); at a local minimum, bump the
weights of violated rows. Per-climber objective weights decay at every
bump (annealing toward pure feasibility) and bumps decay stale weights
(w <- 0.95 w + (1 + viol)), as in cuopt_tpu.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from cuopt_torch.sparse.ops import _csr_to_ell, _transpose_csr

# cap on the bytes of one (climbers, block, Lc, K) scoring intermediate
_SCORE_BYTES = 256 << 20


@dataclass
class FjProblem:
    # ELL of A (rows): values/cols, padded with 0
    row_vals: torch.Tensor  # (n, L)
    row_cols: torch.Tensor
    # ELL of A^T (vars -> incident rows)
    col_vals: torch.Tensor  # (m, Lc)
    col_rows: torch.Tensor
    col_mask: torch.Tensor  # (m, Lc) True where a real entry
    lc0: torch.Tensor  # (n,) finite-filled
    uc0: torch.Tensor
    lc_fin: torch.Tensor
    uc_fin: torch.Tensor
    c: torch.Tensor  # (m,)
    lv: torch.Tensor
    uv: torch.Tensor
    is_int: torch.Tensor  # (m,) bool
    # (n,) how far inside its bounds each row is aimed (make_fj_problem's
    # margin); feasibility is judged against the bounds themselves
    margin: torch.Tensor
    # a bump sets w <- decay w + (1 + v) on a violated row and
    # w <- decay w + rest w on a satisfied one (cuopt_tpu: 0.95, 0.05)
    decay: float = 0.95
    rest: float = 0.05


@dataclass
class FjState:
    """A batch of climbers: every field has a leading climber axis."""

    x: torch.Tensor  # (B, m)
    act: torch.Tensor  # (B, n)
    w: torch.Tensor  # (B, n) constraint weights
    best_x: torch.Tensor  # (B, m)
    best_obj: torch.Tensor  # (B,)
    has_feasible: torch.Tensor  # (B,) bool
    steps: torch.Tensor  # (B,) int64
    obj_weight: torch.Tensor  # (B,) annealed on stalls

    def replace(self, **kw) -> "FjState":
        return dataclasses.replace(self, **kw)


def _violation(act, p: FjProblem):
    """Each row's distance from its target interval."""
    lo = torch.where(p.lc_fin, (p.lc0 - act).clamp(min=0.0), 0.0)
    hi = torch.where(p.uc_fin, (act - p.uc0).clamp(min=0.0), 0.0)
    return lo + hi


def _shortfall(act, p: FjProblem):
    """Each row's violation of its own bounds (its target's, widened by
    the margin)."""
    return (_violation(act, p) - p.margin).clamp(min=0.0)


def make_fj_problem(prob, dtype=torch.float64, device="cuda",
                    margin=0.0, decay=0.95) -> FjProblem:
    """Build the FJ device problem from a host OptimizationProblem. With
    `margin`, the climbers aim every row `margin` times its 1-norm inside
    its bounds (at most half a ranged row's width; none for an equality),
    so that the few rows they leave violated at a local minimum can still
    lie within the bounds themselves. `decay` is the bump's weight decay:
    cuopt_tpu's 0.95 caps a violated row's weight at 20 (1 + v); 1.0
    lets it grow without bound, as in Luteberget and Sartor's FJ."""
    n, m = prob.n_constraints, prob.n_variables
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    L = max(int(np.max(np.diff(prob.offsets), initial=0)), 1)
    rv, ri = _csr_to_ell(prob.offsets, prob.indices, prob.values, n, L,
                         np_dtype)
    t_off, t_idx, t_val, _ = _transpose_csr(
        prob.offsets, prob.indices, prob.values, n, m)
    Lc = max(int(np.max(np.diff(t_off), initial=0)), 1)
    cv, cr = _csr_to_ell(t_off, t_idx, t_val, m, Lc, np_dtype)
    lc = np.asarray(prob.constraint_lower_bounds, np_dtype)
    uc = np.asarray(prob.constraint_upper_bounds, np_dtype)
    delta = np.zeros(n, np_dtype)
    if margin:
        norm1 = np.bincount(
            np.repeat(np.arange(n), np.diff(prob.offsets)),
            weights=np.abs(prob.values), minlength=n)
        width = np.where(np.isfinite(lc) & np.isfinite(uc), uc - lc, np.inf)
        delta = np.minimum(margin * norm1, width / 2).astype(np_dtype)
        lc, uc = lc + delta, uc - delta
    sign = -1.0 if prob.maximize else 1.0

    def t(a, dt=None):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return FjProblem(
        row_vals=t(rv), row_cols=t(ri),
        col_vals=t(cv), col_rows=t(cr), col_mask=t(cv != 0.0),
        lc0=t(np.where(np.isfinite(lc), lc, 0.0)),
        uc0=t(np.where(np.isfinite(uc), uc, 0.0)),
        lc_fin=t(np.isfinite(lc)), uc_fin=t(np.isfinite(uc)),
        c=t(sign * prob.objective_coefficients, dtype),
        lv=t(prob.variable_lower_bounds, dtype),
        uv=t(prob.variable_upper_bounds, dtype),
        is_int=t(prob.variable_types == "I"),
        margin=t(delta),
        decay=decay, rest=0.05 if decay == 0.95 else 1.0 - decay,
    )


def init_state(p: FjProblem, x0s, obj_weights) -> FjState:
    """A batch of climbers started at the rows of `x0s` with the given
    objective weights."""
    dt, dev = p.c.dtype, p.c.device
    x = torch.as_tensor(np.asarray(x0s, np.float64), dtype=dt, device=dev)
    x = torch.clamp(x, p.lv, p.uv)
    x = torch.where(p.is_int, torch.round(x), x)
    # row activities summed entry by entry in ELL order, the order of
    # cuopt_tpu's XLA row sum on the CPU: from the same start both
    # packages then climb through the same bits
    act = torch.zeros(x.shape[0], p.row_vals.shape[0], dtype=dt, device=dev)
    for k in range(p.row_vals.shape[1]):
        act = act + p.row_vals[:, k] * x[:, p.row_cols[:, k]]
    big = torch.finfo(dt).max
    feas = _shortfall(act, p).sum(1) <= 1e-6
    obj = x @ p.c
    return FjState(
        x=x, act=act, w=torch.ones_like(act), best_x=x,
        best_obj=torch.where(feas, obj, big),
        has_feasible=feas,
        steps=torch.zeros(x.shape[0], dtype=torch.int64, device=dev),
        obj_weight=torch.as_tensor(np.asarray(obj_weights, np.float64),
                                   dtype=dt, device=dev),
    )


def score_vars(p: FjProblem, s: FjState, cols: torch.Tensor):
    """Candidate values T and scores of each climber's variables `cols`
    (B, k), both (B, k, K): the change in weighted violation over each
    variable's incident rows plus the climber's objective term; a no-move
    candidate scores finfo.max / 4. A variable's scores depend only on its
    own column, x_j, and the activities and weights of its rows (padded
    slots read row 0), so they come out the same bits whichever variables
    are scored beside it."""
    big = torch.finfo(s.x.dtype).max / 4
    B, k = cols.shape
    cr = p.col_rows[cols]  # (B, k, Lc)
    a = p.col_vals[cols]
    mask = p.col_mask[cols]
    x = s.x.gather(1, cols)  # (B, k)
    act_j = s.act.gather(1, cr.reshape(B, -1)).reshape(cr.shape)
    safe_a = torch.where(mask, a, 1.0)
    lc0r, uc0r = p.lc0[cr], p.uc0[cr]
    target = torch.minimum(torch.maximum(act_j, lc0r), uc0r)
    # move that puts incident row exactly at its nearest bound
    t_bp = x[:, :, None] + (target - act_j) / safe_a
    T = torch.cat([t_bp, torch.floor(t_bp), torch.ceil(t_bp),
                   (x + 1.0)[:, :, None], (x - 1.0)[:, :, None]], dim=2)
    lv, uv = p.lv[cols][..., None], p.uv[cols][..., None]
    T = torch.minimum(torch.maximum(T, lv), uv)
    T = torch.where(p.is_int[cols][..., None], torch.round(T), T)

    dx = T - x[:, :, None]  # (B, k, K)
    # (B, k, Lc, K): activity of row cr[j, l] when x_j -> T[j, q]
    act_new = act_j[..., None] + a[..., None] * dx[:, :, None, :]
    lc0r, uc0r = lc0r[..., None], uc0r[..., None]
    lfin, ufin = p.lc_fin[cr][..., None], p.uc_fin[cr][..., None]
    viol_new = (torch.where(lfin, (lc0r - act_new).clamp(min=0.0), 0.0)
                + torch.where(ufin, (act_new - uc0r).clamp(min=0.0), 0.0))
    act_old = act_j[..., None]
    viol_old = (torch.where(lfin, (lc0r - act_old).clamp(min=0.0), 0.0)
                + torch.where(ufin, (act_old - uc0r).clamp(min=0.0), 0.0))
    w_j = s.w.gather(1, cr.reshape(B, -1)).reshape(cr.shape)
    wj = (w_j * mask)[..., None]
    score = (wj * (viol_new - viol_old)).sum(2)  # (B, k, K)
    score = score + s.obj_weight[:, None, None] * p.c[cols][..., None] * dx
    return T, torch.where(dx == 0.0, big, score)


def score_block(p: FjProblem, s: FjState, j0: int, j1: int):
    """`score_vars` of variables j0:j1 in every climber."""
    cols = torch.arange(j0, j1, device=s.x.device)
    return score_vars(p, s, cols.expand(s.x.shape[0], -1))


def score_all(p: FjProblem, s: FjState, block: int):
    """`score_vars` of every variable, in blocks of `block` variables:
    T and score, both (B, m, K)."""
    m = s.x.shape[1]
    parts = [score_block(p, s, j0, min(j0 + block, m))
             for j0 in range(0, m, block)]
    return (torch.cat([t for t, _ in parts], dim=1),
            torch.cat([sc for _, sc in parts], dim=1))


def score_block_size(p: FjProblem, n_climbers: int,
                     cap_bytes: int = _SCORE_BYTES) -> int:
    """Variables per scoring block: the most that keep one
    (climbers, block, Lc, K) intermediate within `cap_bytes`."""
    m, Lc = p.col_vals.shape
    per_var = n_climbers * Lc * (3 * Lc + 2) * p.c.element_size()
    return int(max(1, min(m, cap_bytes // per_var)))


def _fj_step(p: FjProblem, s: FjState, T, score):
    """One step of every climber from the scores (T, score) of its state.
    Returns the new state, the variable index j* it scored best (B, 1),
    and whether it moved there (B,); at a local minimum it bumped its
    weights instead."""
    B = s.x.shape[0]
    K = T.shape[2]
    flat = score.reshape(B, -1).argmin(1, keepdim=True)  # (B, 1)
    best_score = score.reshape(B, -1).gather(1, flat)[:, 0]
    t_star = T.reshape(B, -1).gather(1, flat)
    j_star = flat // K  # (B, 1)

    # move: x_j* <- t*, and the activities of its incident rows
    dxs = t_star - s.x.gather(1, j_star)
    x_mv = s.x.scatter(1, j_star, t_star)
    rows = p.col_rows[j_star[:, 0]]  # (B, Lc)
    deltas = torch.where(p.col_mask[j_star[:, 0]],
                         p.col_vals[j_star[:, 0]] * dxs, 0.0)
    act_mv = s.act.scatter_add(1, rows, deltas)
    # bump: Lagrangian-style decayed weights (rho = 0.95); annealing
    # shifts the climber toward pure feasibility
    v = _violation(s.act, p)
    w_bump = p.decay * s.w + torch.where(v > 0, 1.0 + v, p.rest * s.w)
    improving = best_score < -1e-9  # (B,)
    mv = improving[:, None]
    x = torch.where(mv, x_mv, s.x)
    act = torch.where(mv, act_mv, s.act)
    s = s.replace(
        x=x, act=act, w=torch.where(mv, s.w, w_bump),
        obj_weight=torch.where(improving, s.obj_weight,
                               s.obj_weight * 0.9))

    # track incumbents
    feas = _shortfall(act, p).sum(1) <= 1e-6
    obj = x @ p.c
    better = feas & (obj < s.best_obj)
    return s.replace(
        best_x=torch.where(better[:, None], x, s.best_x),
        best_obj=torch.where(better, obj, s.best_obj),
        has_feasible=s.has_feasible | feas,
        steps=s.steps + 1,
    ), j_star, improving


def _map(s: FjState, fn) -> FjState:
    """`fn` applied to every field of a batch."""
    return FjState(**{f.name: fn(getattr(s, f.name))
                      for f in dataclasses.fields(FjState)})


def _refresh(p: FjProblem, s: FjState, j_star, moved, T, score):
    """Rescore in T and score, in place, the variables that each
    climber's last step changed (s is the state after it). Returns the
    mask of climbers that must rescore all their variables instead."""
    rows = p.col_rows[j_star[:, 0]]  # (B, Lc)
    row0 = ((rows == 0) & p.col_mask[j_star[:, 0]]).any(1)
    cols = torch.cat([p.row_cols[rows].reshape(rows.shape[0], -1), j_star],
                     dim=1)
    t_n, sc_n = score_vars(p, s, cols)
    at = cols[:, :, None].expand(-1, -1, T.shape[2])
    T.scatter_(1, at, t_n)
    score.scatter_(1, at, sc_n)
    return ~moved | row0


class _GraphedStep:
    """`_fj_step` and `_refresh` over static buffers (state, T, score),
    captured as one CUDA graph: a replay is one launch where the eager
    step issues about 75 small ones (on an H100 a 50k step took 3.3 ms
    eagerly, 1.3 ms replayed). The graph is captured on a stream of its
    own in thread-local mode, so a solve's other threads go on using the
    card."""

    def __init__(self, p: FjProblem, s: FjState, T, score):
        self.s = _map(s, torch.clone)
        self.T, self.score = T.clone(), score.clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(),
                              capture_error_mode="thread_local"):
            s2, j_star, moved = _fj_step(p, self.s, self.T, self.score)
            self.redo = _refresh(p, s2, j_star, moved, self.T, self.score)
            for f in dataclasses.fields(FjState):
                getattr(self.s, f.name).copy_(getattr(s2, f.name))

    def load(self, s: FjState, T, score):
        for f in dataclasses.fields(FjState):
            getattr(self.s, f.name).copy_(getattr(s, f.name))
        self.T.copy_(T)
        self.score.copy_(score)


def fj_chunk(p: FjProblem, s: FjState, n_steps: int,
             block: int | None = None, stats: dict | None = None) -> FjState:
    """`n_steps` FJ steps of every climber in the batch. `block` is the
    scoring block (variables), by default `score_block_size`.

    Every variable is scored once, at the start; after that a step
    rescores only what it changed, which gives the same bits as scoring
    everything again (score_vars):
      - a climber that moved x_j* changed x_j* and the activities of j*'s
        rows, so it rescores the variables of those rows; where one of
        them is row 0, which every padded slot reads, it rescores all;
      - a climber that bumped changed its weights and objective weight,
        so it rescores all.
    Which climbers rescore all is the step's one host read. Where a
    move's neighbourhood (Lc rows of L variables) is not under half the
    variables, every step rescores all, with no host read. On a CUDA batch
    the step and its partial rescoring replay a CUDA graph kept on `p`
    (one per climber count), the same kernels as the eager step. `stats`,
    if given, counts the full rescorings of single climbers under
    "full_rescores"."""
    B, m = s.x.shape
    block = block or score_block_size(p, B)
    T, score = score_all(p, s, block)
    if 2 * (p.col_rows.shape[1] * p.row_cols.shape[1] + 1) >= m:
        for _ in range(n_steps):
            s = _fj_step(p, s, T, score)[0]
            T, score = score_all(p, s, block)
        _count(stats, n_steps * B)
        return s
    g = None
    if s.x.is_cuda:
        graphs = p.__dict__.setdefault("_step_graphs", {})
        if B not in graphs:
            graphs[B] = _GraphedStep(p, s, T, score)
        g = graphs[B]
        g.load(s, T, score)
        s, T, score = g.s, g.T, g.score
    for _ in range(n_steps):
        if g is not None:
            g.graph.replay()
            redo = g.redo
        else:
            s, j_star, moved = _fj_step(p, s, T, score)
            redo = _refresh(p, s, j_star, moved, T, score)
        redo = torch.nonzero(redo)[:, 0]  # the step's one host read
        if len(redo):
            t_r, sc_r = score_all(p, _map(s, lambda v: v[redo]), block)
            T[redo] = t_r
            score[redo] = sc_r
            _count(stats, len(redo))
    # the graph's buffers are reloaded by the next chunk
    return s if g is None else _map(s, torch.clone)


def _count(stats, n):
    if stats is not None:
        stats["full_rescores"] = stats.get("full_rescores", 0) + n


def _fj_batch_size(prob):
    """Climber-batch size by per-step tensor volume (cuopt_tpu's rule):
    small problems take more climbers, big ones a small batch."""
    m = prob.n_variables
    col_nnz = np.zeros(m, np.int64)
    np.add.at(col_nnz, prob.indices, 1)
    lc = max(int(col_nnz.max(initial=0)), 1)
    k = 3 * lc + 2
    elems = m * lc * k
    return int(min(64, max(9, 4_000_000 // max(elems, 1))))


class FjEngine:
    """Persistent FJ worker: the climber batch lives on `device` and is
    chunk-stepped for the whole solve, with incumbent-aware reseeding, the
    analogue of the reference's heuristic GPU stream that runs FJ kernels
    alongside the CPU B&B (cpp/src/mip/solver.cu:179 `dm.run_solver()`).
    """

    def __init__(self, prob, x_starts, seed=0, dtype=torch.float64,
                 steps_per_chunk=64, obj_weight=1e-3, device="cuda",
                 margin=0.0, decay=0.95):
        self.prob = prob
        self.device = torch.device(device)
        self.p = make_fj_problem(prob, dtype, self.device, margin, decay)
        self.dtype = dtype
        self.steps_per_chunk = steps_per_chunk
        self.obj_weight = obj_weight
        self.rng = np.random.default_rng(seed + 7)
        self.is_int = np.asarray(prob.variable_types == "I")
        self.lv = np.asarray(prob.variable_lower_bounds, float)
        self.uv = np.asarray(prob.variable_upper_bounds, float)
        # mode spread over the climber batch: given starts at graded
        # objective weights, plus an "on-zero" pure-feasibility climber
        self.batch_size = _fj_batch_size(prob)
        weights = [obj_weight, 10 * obj_weight, 0.1 * obj_weight, 0.0]
        x_starts = list(x_starts)[: self.batch_size - 1]
        xs = list(x_starts)
        ws = [weights[i % len(weights)] for i in range(len(xs))]
        xs.append(np.zeros(prob.n_variables))
        ws.append(0.0)
        k = 0
        while len(xs) < self.batch_size and x_starts:
            xs.append(x_starts[k % len(x_starts)])
            ws.append(weights[(k + 1) % len(weights)])
            k += 1
        self.batch = init_state(self.p, np.stack(xs), ws)
        self.block = score_block_size(self.p, self.batch_size)
        self.pushed_obj = np.inf
        self.chunks = 0
        self.stats = {"full_rescores": 0}

    def step(self):
        """Run one chunk. Returns (best_x, best_obj) when a new best
        feasible solution appeared this chunk, else None."""
        self.batch = fj_chunk(self.p, self.batch, self.steps_per_chunk,
                              self.block, self.stats)
        self.chunks += 1
        objs = self.batch.best_obj.cpu().numpy()  # syncs the chunk
        found = self.batch.has_feasible.cpu().numpy()
        if not found.any():
            return None
        k = int(np.argmin(np.where(found, objs, np.inf)))
        if objs[k] < self.pushed_obj - 1e-9:
            self.pushed_obj = float(objs[k])
            return self.batch.best_x[k].cpu().numpy(), float(objs[k])
        return None

    def _perturb(self, x_inc, frac):
        """Flip/jitter a random fraction of the integer variables."""
        x = np.asarray(x_inc, float).copy()
        idx = np.where(self.is_int)[0]
        if len(idx) == 0:
            return x
        k = max(1, int(frac * len(idx)))
        pick = self.rng.choice(idx, size=min(k, len(idx)), replace=False)
        lo, hi = self.lv[pick], self.uv[pick]
        binary = (hi - lo <= 1.0 + 1e-9) & np.isfinite(lo) & np.isfinite(hi)
        flip = np.where(binary, lo + hi - x[pick],
                        x[pick] + self.rng.choice([-1.0, 1.0], len(pick)))
        x[pick] = np.clip(flip, lo, hi)
        return x

    def reseed(self, x_inc, n_replace=None):
        """Incumbent-aware restarts: replace the worst climbers with
        perturbations of the incumbent (fresh constraint weights), one
        exactly AT the incumbent. The climbers keep the incumbents they
        already track."""
        if n_replace is None:
            n_replace = max(3, self.batch_size // 8)
        b = self.batch
        objs = np.where(b.has_feasible.cpu().numpy(),
                        b.best_obj.cpu().numpy(), np.inf)
        repl = np.argsort(-objs)[:n_replace]  # worst first
        weights = [self.obj_weight, 0.1 * self.obj_weight, 0.0]
        xs, ws = [], []
        for t in range(len(repl)):
            xs.append(x_inc if t == 0 else
                      self._perturb(x_inc, 0.05 * (t + 1)))
            # cuopt_tpu draws a PRNG seed for each fresh climber here;
            # the draw keeps this engine's perturbations on its stream
            self.rng.integers(1 << 30)
            ws.append(weights[t % len(weights)])
        fresh = init_state(self.p, np.stack(xs), ws)
        idx = torch.as_tensor(repl, device=self.device)
        keep = ("best_x", "best_obj", "has_feasible")
        merged = {}
        for f in dataclasses.fields(FjState):
            v = getattr(b, f.name)
            if f.name not in keep:
                v = v.clone()
                v[idx] = getattr(fresh, f.name)
            merged[f.name] = v
        self.batch = FjState(**merged)


def run_feasibility_jump(prob, x_starts, time_budget_s, seed=0,
                         dtype=torch.float64, steps_per_chunk=64,
                         obj_weight=1e-3, device="cuda"):
    """One-shot driver over FjEngine: chunk until the time budget is
    spent, after a first chunk that the budget does not count. Returns
    (best_x, best_obj, found) in the INTERNAL minimize orientation."""
    eng = FjEngine(prob, x_starts, seed=seed, dtype=dtype,
                   steps_per_chunk=steps_per_chunk, obj_weight=obj_weight,
                   device=device)
    eng.step()
    t_end = time.monotonic() + time_budget_s
    while time.monotonic() < t_end:
        eng.step()
    objs = eng.batch.best_obj.cpu().numpy()
    found = eng.batch.has_feasible.cpu().numpy()
    if not found.any():
        return None, np.inf, False
    k = int(np.argmin(np.where(found, objs, np.inf)))
    return eng.batch.best_x[k].cpu().numpy(), float(objs[k]), True
