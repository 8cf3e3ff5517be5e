"""Routing population islands over a mesh (cuopt_tpu/routing/islands.py).

The island model of the reference's population solver
(cpp/src/routing/diversity/diverse_solver.hpp:151): each shard of a mesh
(parallel/sharding.py) owns one island of P solutions, and an epoch

  1. runs a greedy local-search sweep (`evaluate_moves` of
     routing/local_search.py, then the best move applied on the device)
     on every member of the island at once, under torch.func.vmap;
  2. sends each island's champion one step round the ring (island d
     receives island (d - 1) % D's), where it replaces the island's
     worst member unless it is no better;
  3. takes the pmin of the champions' costs, so that every island knows
     the global best.

Solutions are (F, L) route matrices of serve-order ids padded with -1,
with per-route lengths, the solver's fixed-shape form. As in cuopt_tpu,
routing.Solve does not call the islands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vmap

from cuopt_torch.parallel.sharding import run_spmd
from cuopt_torch.routing.local_search import LsProblem, evaluate_moves


# ------------------------------------------------------------------ apply
def _at(v, i):
    """v[i] for a 1-D v and a 0-d index (vmap-safe)."""
    return v.gather(0, i.reshape(1)).squeeze(0)


def _row(R, f):
    """R[f] for a 0-d route index (vmap-safe)."""
    return R.index_select(0, f.reshape(1)).squeeze(0)


def _remove_at(row, length, i):
    """Remove list index i from a -1-padded row."""
    L = row.shape[0]
    pos = torch.arange(L, device=row.device)
    src = torch.clamp(pos + (pos >= i).to(pos.dtype), max=L - 1)
    return torch.where(pos >= length - 1, -1, row.gather(0, src))


def _insert_at(row, length, j, val):
    """Insert val at slot j (before the current index j)."""
    L = row.shape[0]
    pos = torch.arange(L, device=row.device)
    shifted = row.gather(0, torch.clamp(pos - 1, min=0))
    out = torch.where(pos < j, row, torch.where(pos == j, val, shifted))
    return torch.where(pos > length, -1, out)


def _remove2_at(row, length, i):
    L = row.shape[0]
    pos = torch.arange(L, device=row.device)
    src = torch.clamp(pos + 2 * (pos >= i).to(pos.dtype), max=L - 1)
    return torch.where(pos >= length - 2, -1, row.gather(0, src))


def _insert2_at(row, length, j, a, b):
    L = row.shape[0]
    pos = torch.arange(L, device=row.device)
    shifted = row.gather(0, torch.clamp(pos - 2, min=0))
    out = torch.where(pos < j, row, torch.where(
        pos == j, a, torch.where(pos == j + 1, b, shifted)))
    return torch.where(pos > length + 1, -1, out)


def _set_rows(R, lens, f1, row1, len1, f2, row2, len2):
    idx = torch.arange(R.shape[0], device=R.device)
    R = torch.where((idx == f1)[:, None], row1[None], R)
    R = torch.where((idx == f2)[:, None], row2[None], R)
    lens = torch.where(idx == f1, len1, lens)
    lens = torch.where(idx == f2, len2, lens)
    return R, lens


def apply_move(p: LsProblem, R, lens, kind, mv):
    """Apply one move of evaluate_moves' encoding on the device (the
    host's twin is in routing/solver.py). Every family's result is built
    and `kind` selects one, where cuopt_tpu takes a lax.switch, so the
    function needs no host read and vmaps."""
    a, b, c, d = mv.unbind()
    L = R.shape[1]
    pos = torch.arange(L, device=R.device)
    la, lc = _at(lens, a), _at(lens, c)

    # relocate (r2, slot j, r1, i)
    u = _at(_row(R, c), d)
    out = [_set_rows(R, lens, c, _remove_at(_row(R, c), lc, d), lc - 1,
                     a, _insert_at(_row(R, a), la, b, u), la + 1)]
    # swap (r1, i, r2, k)
    row_a, row_c = _row(R, a), _row(R, c)
    u, w = _at(row_a, b), _at(row_c, d)
    row_a = torch.where(pos == b, w, row_a)
    row_c = torch.where(pos == d, u, torch.where(a == c, row_a, row_c))
    out.append(_set_rows(R, lens, a, row_a, la, c, row_c, lc))
    # 2-opt (r, i, r, k): reverse positions i..k
    src = torch.where((pos >= b) & (pos <= d), d - (pos - b), pos)
    row = _row(R, a).gather(0, src)
    out.append(_set_rows(R, lens, a, row, la, a, row, la))
    # 2-opt* (r1, cut i, r2, cut k): exchange the tails
    n1 = b + (lc - d)
    n2 = d + (la - b)
    row_a, row_c = _row(R, a), _row(R, c)
    row1 = torch.where(pos < b, row_a,
                       row_c.gather(0, torch.clamp(pos - b + d, 0, L - 1)))
    row2 = torch.where(pos < d, row_c,
                       row_a.gather(0, torch.clamp(pos - d + b, 0, L - 1)))
    out.append(_set_rows(R, lens, a, torch.where(pos < n1, row1, -1), n1,
                         c, torch.where(pos < n2, row2, -1), n2))
    # or-opt of two (r2, slot j, r1, i)
    row_c = _row(R, c)
    u = _at(row_c, d)
    w = _at(row_c, torch.clamp(d + 1, max=L - 1))
    out.append(_set_rows(R, lens, c, _remove2_at(row_c, lc, d), lc - 2,
                         a, _insert2_at(_row(R, a), la, b, u, w), la + 2))
    R_out, lens_out = out[0]
    for k in range(1, 5):
        R_out = torch.where(kind == k, out[k][0], R_out)
        lens_out = torch.where(kind == k, out[k][1], lens_out)
    return R_out, lens_out


def solution_cost_device(p: LsProblem, R, lens):
    """Total cost (arcs + fixed), the host route_cost model: empty routes
    cost nothing; skip_first / drop_return drop the terminal legs
    (routing/internal.py). Summed in float64, where the float32 terms add
    up without rounding, so a member's cost has the same bits however
    many members one launch reduces. (In float32, as cuopt_tpu sums, the
    bits depend on the reduction's layout on the card; two champions of
    equal cost then ranked differently in four shards and in their
    one-device simulation, and the migrations differed.)"""
    F, L = R.shape
    valid = R >= 0
    Rc = torch.where(valid, R, 0)
    locs_mid = torch.where(valid, p.order_loc[Rc], p.veh_return[:, None])
    locs = torch.cat([p.veh_start[:, None], locs_mid, p.veh_return[:, None]],
                     dim=1)
    c_arc = p.cost_mats[p.veh_ti[:, None], locs[:, :-1], locs[:, 1:]]
    pos = torch.arange(L + 1, device=R.device)
    keep = pos[None] <= lens[:, None]
    keep = keep & ~((pos[None] == 0) & p.skip_first[:, None])
    keep = keep & ~((pos[None] == lens[:, None]) & p.drop_return[:, None])
    c_arc = torch.where(keep & (lens > 0)[:, None], c_arc, 0.0)
    fixed = torch.where(lens > 0, p.veh_fixed, 0.0)
    return c_arc.to(torch.float64).sum() + fixed.to(torch.float64).sum()


# ------------------------------------------------------------------ sweep
def ls_sweep(p: LsProblem, R, lens, n_steps: int):
    """Greedy best-move descent on the device: n_steps rounds of
    evaluate_moves + apply_move, a solution frozen from the first round
    that finds no improving move."""
    done = torch.zeros((), dtype=torch.bool, device=R.device)
    for _ in range(n_steps):
        best, kind, mv = evaluate_moves(p, R, lens)
        improved = (best < -1e-6) & ~done
        R2, lens2 = apply_move(p, R, lens, kind, mv)
        R = torch.where(improved, R2, R)
        lens = torch.where(improved, lens2, lens)
        done = done | ~improved
    return R, lens


def _sweep_members(p, Rs, lenss, n_steps):
    """ls_sweep on every member, vmapped, and the members' costs."""
    Rs, lenss = vmap(lambda R, ln: ls_sweep(p, R, ln, n_steps))(Rs, lenss)
    costs = vmap(lambda R, ln: solution_cost_device(p, R, ln))(Rs, lenss)
    return Rs, lenss, costs


def problem_to(p: LsProblem, device) -> LsProblem:
    """`p` with every tensor on `device`."""
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(device)
        for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)})


def _island_epoch_inner(comm, p, Rs, lenss, n_steps):
    """One shard's epoch: its members swept, its champion sent round the
    ring, the global best cost taken."""
    Rs, lenss, costs = _sweep_members(p, Rs, lenss, n_steps)
    kbest = torch.argmin(costs)   # the first minimum, as jnp.argmin
    champ_R, champ_len, champ_cost = Rs[kbest], lenss[kbest], costs[kbest]
    D = comm.size
    ring = [(i, (i + 1) % D) for i in range(D)]
    mig_R = comm.ppermute(champ_R, ring)
    mig_len = comm.ppermute(champ_len, ring)
    mig_cost = comm.ppermute(champ_cost, ring)
    # the neighbour's champion replaces this island's worst member
    # unless it is no better
    kworst = torch.argmax(costs)
    take = mig_cost < costs[kworst]
    Rs, lenss, costs = Rs.clone(), lenss.clone(), costs.clone()
    Rs[kworst] = torch.where(take, mig_R, Rs[kworst])
    lenss[kworst] = torch.where(take, mig_len, lenss[kworst])
    costs[kworst] = torch.where(take, mig_cost, costs[kworst])
    best_cost = comm.pmin(champ_cost)
    return Rs, lenss, costs, best_cost


def island_epoch(p: LsProblem, Rs, lenss, mesh, n_steps=8):
    """One evolution epoch over the mesh's shards.

    Rs: (D * P, F, L) member route matrices and lenss: (D * P, F), island
    d holding members [d P, (d + 1) P). Returns (Rs, lenss, member costs,
    global best cost) on Rs's device."""
    D = mesh.size
    if Rs.shape[0] % D:
        raise ValueError(f"{Rs.shape[0]} members do not split into {D} "
                         f"islands")
    Rs = torch.as_tensor(Rs, dtype=torch.int64)
    lenss = torch.as_tensor(lenss, dtype=torch.int64)
    home = Rs.device
    args = [(problem_to(p, dev), R.to(dev), ln.to(dev), n_steps)
            for dev, R, ln in zip(mesh.devices, Rs.chunk(D), lenss.chunk(D))]
    out = run_spmd(mesh, _island_epoch_inner, args)
    return (torch.cat([o[0].to(home) for o in out]),
            torch.cat([o[1].to(home) for o in out]),
            torch.cat([o[2].to(home) for o in out]),
            out[0][3].to(home))


def simulate_epoch(p: LsProblem, Rs, lenss, n_islands: int, n_steps=8):
    """The epoch of `island_epoch` on one device, the plain version the
    sharded one is held against: every member swept under one vmap,
    then the ring migration and the best cost in numpy. Returns numpy
    (Rs, lenss, costs, best cost)."""
    Rs = torch.as_tensor(Rs, dtype=torch.int64, device=p.device)
    lenss = torch.as_tensor(lenss, dtype=torch.int64, device=p.device)
    Rw, lw, cw = (t.cpu().numpy() for t in _sweep_members(p, Rs, lenss,
                                                          n_steps))
    D = n_islands
    F, L = Rw.shape[1:]
    Rw, lw, cw = Rw.reshape(D, -1, F, L), lw.reshape(D, -1, F), \
        cw.reshape(D, -1)
    champ, worst = cw.argmin(axis=1), cw.argmax(axis=1)
    champ_R = Rw[np.arange(D), champ].copy()
    champ_l = lw[np.arange(D), champ].copy()
    champ_c = cw[np.arange(D), champ].copy()
    for d in range(D):
        src = (d - 1) % D
        if champ_c[src] < cw[d, worst[d]]:
            Rw[d, worst[d]] = champ_R[src]
            lw[d, worst[d]] = champ_l[src]
            cw[d, worst[d]] = champ_c[src]
    return (Rw.reshape(-1, F, L), lw.reshape(-1, F), cw.reshape(-1),
            float(champ_c.min()))


def make_island_members(prob, R0, lens0, n_members, rng=None, tries=100):
    """Tile one solution into an island population, each copy after the
    first with two orders of two random routes swapped, as cuopt_tpu's
    make_island_members draws them (islands.py:252), but redrawn (up to
    `tries` times, else a plain copy) while the swap breaks either
    route's time windows or capacity (`prob.route_feasible`). cuopt_tpu
    keeps every swap, so its members can be infeasible, and so can the
    champion its islands return: the local search does not repair a
    route that is already late (GHC_200_1: the best of 16 members was
    439.7 late after two epochs)."""
    rng = rng or np.random.default_rng(0)
    R0 = np.asarray(R0)
    lens0 = np.asarray(lens0)
    Rs, lenss = [R0], [lens0]
    nz = np.where(lens0 > 0)[0]
    for _ in range(n_members - 1):
        R = R0.copy()
        for _ in range(tries if len(nz) >= 2 else 0):
            f1, f2 = rng.choice(nz, 2, replace=False)
            i = int(rng.integers(lens0[f1]))
            k = int(rng.integers(lens0[f2]))
            C = R0.copy()
            C[f1, i], C[f2, k] = C[f2, k], C[f1, i]
            if all(prob.route_feasible(int(f), [int(o) for o in
                                                C[f, :lens0[f]]])
                   for f in (f1, f2)):
                R = C
                break
        Rs.append(R)
        lenss.append(lens0.copy())
    return np.stack(Rs), np.stack(lenss)
