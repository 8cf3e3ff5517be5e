"""Several devices driven from one process: the mesh, its collectives and
the row-partitioned PDLP layout.

Counterpart of cuopt_tpu/parallel/sharding.py. cuopt_tpu commits arrays
to a `jax.sharding.Mesh` and lets GSPMD insert the collectives; here the
mesh is an ordered tuple of torch devices and every collective is
explicit:

  - `run_spmd(mesh, fn, per_shard_args)` runs `fn` once per shard, each
    in a thread of its own, on its own device and (on a card) its own
    CUDA stream, with a `ShardComm` holding the collectives that
    cuopt_tpu's `shard_map` bodies use: psum, pmin, pmax, all_gather
    and ppermute. One process drives every shard, as one JAX controller
    drives every device of its mesh; a mesh may repeat a device, so four
    shards can run on one card (and eight on the CPU, as the tests do).
  - Every collective combines the shards' parts in shard order, never in
    order of arrival, so every shard gets the same bits: the shards
    decide restarts, termination and the attempt loop from these values,
    and shards that decided differently would part ways.
  - A part crosses from one shard's stream to another's only after the
    reader's stream waited on an event recorded on the writer's.
  - An exception in any shard aborts the rendezvous and is raised in the
    caller; shards that reach different collectives (or one that returns
    while another waits at a collective) raise too, so no disagreement
    between shards ends in a hang. A rendezvous has no timeout: the
    shards of a split batch may finish minutes apart.

The PDLP layout is that of cuopt_tpu (sharding.py:155-217): y-space
vectors are row-sharded; x-space vectors are sharded when the column
count divides by the shard count and replicated otherwise; scalars are
replicated; the operator is split by `_shard_operator` (sparse/ops.py
holds the sharded forms). Scaling runs before sharding, on the whole
problem. `gather_state` puts the pieces back together.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass

import numpy as np
import torch

ROW_AXIS = "rows"
DCN_AXIS = "slices"


# ------------------------------------------------------------------- mesh
class Mesh:
    """An ordered tuple of torch devices laid out in `shape` (row-major)
    with one name per axis. A device may appear more than once: each
    entry is one shard."""

    def __init__(self, devices, shape, axis_names):
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if int(np.prod(self.shape)) != len(self.devices) or \
                len(self.shape) != len(self.axis_names):
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"mesh of shape {self.shape} with axes "
                             f"{self.axis_names}")
        self._lock = threading.Lock()  # one run at a time on a mesh
        self._groups = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def group(self, rank: int, axis=None) -> list[int]:
        """The ranks that share every coordinate with `rank` except those
        of `axis` (a name, a tuple of names, or None for every axis), in
        rank order."""
        key = (rank, axis)
        if key not in self._groups:
            axes = self.axis_names if axis is None else (
                (axis,) if isinstance(axis, str) else tuple(axis))
            for a in axes:
                if a not in self.axis_names:
                    raise ValueError(f"no axis {a!r} in {self.axis_names}")
            keep = [i for i, a in enumerate(self.axis_names)
                    if a not in axes]
            mine = self.coords(rank)
            self._groups[key] = [
                r for r in range(self.size)
                if all(self.coords(r)[i] == mine[i] for i in keep)]
        return self._groups[key]

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"{[str(d) for d in self.devices]})")


def _devices(n, devices):
    if devices is not None:
        devs = []
        for d in map(torch.device, devices):
            if d.type == "cuda":
                # an index on every card, so that a tensor's device (which
                # has one) compares equal to its shard's
                idx = d.index if d.index is not None else 0
                if idx >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"{d} requested, {torch.cuda.device_count()} CUDA "
                        f"cards present")
                d = torch.device("cuda", idx)
            devs.append(d)
        if n is not None and len(devs) != n:
            raise ValueError(f"{len(devs)} devices given for {n} shards")
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return devs
    have = torch.cuda.device_count()
    n = have if n is None else n
    if n < 1 or have < n:
        raise RuntimeError(
            f"make_mesh({n}) needs {n} CUDA cards, {have} present; pass "
            f"devices=[...] to place several shards on one device")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A one-axis ("rows") mesh. With `devices` (a list that may repeat a
    device: ["cuda:0"] * 4 is four shards on one card) its entries are the
    shards; otherwise the first `n_devices` CUDA cards (every card when
    None), raising when fewer exist. Nothing picks the CPU on its own."""
    devs = _devices(n_devices, devices)
    return Mesh(devs, (len(devs),), (ROW_AXIS,))


def make_mesh_2d(n_slices: int, n_per_slice: int, devices=None) -> Mesh:
    """A (slices, rows) mesh: the leading axis models the slow links
    between slices, the trailing one the fast links inside a slice (the
    layout of cuopt_tpu's make_mesh_2d, sharding.py:43)."""
    devs = _devices(n_slices * n_per_slice, devices)
    return Mesh(devs, (n_slices, n_per_slice), (DCN_AXIS, ROW_AXIS))


# ---------------------------------------------------------------- runtime
class ShardDivergence(RuntimeError):
    """Shards reached different collectives."""


class _Run:
    """The rendezvous of one run_spmd call. Parts and tags are double
    buffered: collective k uses buffer k % 2, and no shard can write
    buffer k % 2 again (collective k + 2) before every shard has passed
    the rendezvous of collective k + 1, that is, finished reading k."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.parts = [[None] * n, [None] * n]
        self.tags = [[None] * n, [None] * n]


class ShardComm:
    """Shard `rank`'s side of the mesh's collectives. Valid inside the
    run_spmd call that made it. Every shard of the mesh must call the
    same collectives in the same order (the SPMD contract); `axis` names
    the mesh axis (or tuple of axes, or None for all) to reduce over."""

    def __init__(self, mesh: Mesh, rank: int, run: _Run):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.devices[rank]
        self._run = run
        self._count = 0
        self.collectives = 0      # calls made by this shard
        self.bytes_sent = 0       # bytes of its parts that other shards read

    @property
    def size(self) -> int:
        return self.mesh.size

    # --------------------------------------------------------- plumbing
    def _exchange(self, tag, part):
        run = self._run
        buf = self._count % 2
        self._count += 1
        self.collectives += 1
        if isinstance(part, torch.Tensor) and part.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(part.device))
            part = (part, ev)
        run.parts[buf][self.rank] = part
        run.tags[buf][self.rank] = tag
        run.barrier.wait()
        tags = run.tags[buf]
        if any(t != tag for t in tags):
            raise ShardDivergence(
                f"shard {self.rank} at {tag!r}, the shards at {tags}")
        return run.parts[buf]

    def _take(self, part) -> torch.Tensor:
        """Another shard's tensor, safe to read on this shard's stream,
        on this shard's device."""
        if isinstance(part, tuple):
            t, ev = part
            if t.device == self.device:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
                t.record_stream(cur)  # its memory outlives our reads
                return t
            # a copy between cards runs on the source card's stream
            src = torch.cuda.current_stream(t.device)
            src.wait_event(ev)
            t.record_stream(src)
            return t.to(self.device)
        return part.to(self.device)

    def _parts(self, tag, t, axis):
        parts = self._exchange(tag, t)
        group = self.mesh.group(self.rank, axis)
        self.bytes_sent += t.numel() * t.element_size() * (len(group) - 1)
        return [self._take(parts[r]) for r in group]

    # ------------------------------------------------------- collectives
    def _fold(self, kind, combine, t, axis):
        """combine() the parts of `t` over `axis` left to right in shard
        order, the same bits on every shard."""
        parts = self._parts((kind, axis), t, axis)
        out = parts[0].clone()
        for p in parts[1:]:
            out = combine(out, p)
        return out

    def psum(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """The sum of every shard's `t` over `axis`."""
        return self._fold("psum", torch.add, t, axis)

    def pmax(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        return self._fold("pmax", torch.maximum, t, axis)

    def pmin(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        return self._fold("pmin", torch.minimum, t, axis)

    def all_gather(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """Every shard's `t` concatenated along dim 0 in shard order (the
        parts may differ in length)."""
        return torch.cat(self._parts(("all_gather", axis), t, axis))

    def ppermute(self, t: torch.Tensor, pairs, axis=None) -> torch.Tensor:
        """Send `t` along `pairs` of (source, destination) positions in
        this shard's group over `axis`; a shard that no pair reaches gets
        zeros (jax.lax.ppermute's rule)."""
        parts = self._exchange(("ppermute", axis, tuple(pairs)), t)
        group = self.mesh.group(self.rank, axis)
        me = group.index(self.rank)
        dst_of = dict(pairs)
        if me in dst_of:
            self.bytes_sent += t.numel() * t.element_size()
        src = [s for s, d in pairs if d == me]
        if not src:
            return torch.zeros_like(t)
        return self._take(parts[group[src[0]]]).clone()


def run_spmd(mesh: Mesh, fn, per_shard_args):
    """Run fn(comm, *per_shard_args[rank]) once per shard, in threads, and
    return the results in rank order. On a card each shard runs on a
    stream of its own that first waits for the caller's stream; the
    caller's stream waits for every shard's before this returns. The
    first exception of any shard is raised here after every thread has
    ended."""
    args = list(per_shard_args)
    if len(args) != mesh.size:
        raise ValueError(f"{len(args)} argument tuples for {mesh.size} "
                         f"shards")
    with mesh._lock:
        run = _Run(mesh.size)
        results = [None] * mesh.size
        errors = [None] * mesh.size
        streams = []
        for d in mesh.devices:
            if d.type == "cuda":
                s = torch.cuda.Stream(device=d)
                s.wait_stream(torch.cuda.current_stream(d))
                streams.append(s)
            else:
                streams.append(None)

        def shard(rank):
            comm = ShardComm(mesh, rank, run)
            try:
                dev, stream = mesh.devices[rank], streams[rank]
                if stream is None:
                    results[rank] = fn(comm, *args[rank])
                else:
                    torch.cuda.set_device(dev)
                    with torch.cuda.stream(stream):
                        results[rank] = fn(comm, *args[rank])
                # a last rendezvous: a shard that returned while another
                # waits at a collective makes both raise at once
                comm._exchange(("end",), None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[rank] = e
                run.barrier.abort()

        threads = [threading.Thread(target=shard, args=(r,),
                                    name=f"spmd-shard-{r}", daemon=True)
                   for r in range(mesh.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for d, s in zip(mesh.devices, streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)
    # the shard that failed first; the others saw the aborted barrier
    first = [e for e in errors if e is not None and
             not isinstance(e, threading.BrokenBarrierError)]
    if first:
        raise first[0]
    return results


def hierarchical_psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of `x` split in mesh.size contiguous parts over a (slices,
    rows) mesh, in two stages: a psum over "rows" inside each slice, then
    one scalar per slice across "slices" (cuopt_tpu sharding.py:55-74).
    Returns the sum on x's device."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} values do not split over "
                         f"{mesh.size} shards")
    parts = x.chunk(mesh.size)

    def body(comm, part):
        local = part.sum()
        intra = comm.psum(local, ROW_AXIS)
        return comm.psum(intra, DCN_AXIS)

    out = run_spmd(mesh, body, [(p.to(d),) for p, d in
                                zip(parts, mesh.devices)])
    return out[0].to(x.device)


# ------------------------------------------------------------ PDLP layout
@dataclass(frozen=True)
class Layout:
    """Where each shard's rows and columns lie: shard d owns rows
    [row_splits[d], row_splits[d+1]) and, when the x-space is sharded,
    columns [col_splits[d], col_splits[d+1]); col_splits is None when
    every shard holds all of x."""

    n_rows: int
    n_cols: int
    row_splits: tuple
    col_splits: tuple | None

    def rows(self, d):
        return self.row_splits[d], self.row_splits[d + 1]

    def cols(self, d):
        if self.col_splits is None:
            return 0, self.n_cols
        return self.col_splits[d], self.col_splits[d + 1]


class ShardReduce:
    """Whole-problem reductions of one shard's local partials, for
    lp/pdlp.py: a term over a sharded vector is summed (or maxed) across
    the shards; a term over a replicated vector counts once, from shard
    0's share (the other shards add 0: cuopt_tpu scales such terms by
    1/D instead, pdlp.py:238-249, which rounds). Each call is one packed
    collective."""

    def __init__(self, comm: ShardComm, layout: Layout):
        self.comm = comm
        self.x_sharded = layout.col_splits is not None

    def _sharded(self, space):
        return space == "y" or self.x_sharded

    def psum(self, parts):
        """parts: [(local 0-d partial sum, "x" or "y")] -> whole sums."""
        vals = [p if (self._sharded(s) or self.comm.rank == 0)
                else torch.zeros_like(p) for p, s in parts]
        out = self.comm.psum(torch.stack(vals))
        return list(out.unbind())

    def pmax(self, parts):
        """parts: [(local 0-d maximum, space)] -> whole maxima."""
        out = self.comm.pmax(torch.stack([p for p, _ in parts]))
        return list(out.unbind())


@dataclass
class ShardedProblem:
    """A DeviceProblem split over a mesh: shards[d] is shard d's local
    problem on mesh.devices[d], its operator a sharded form carrying the
    shard's ShardComm while a run is live."""

    mesh: Mesh
    layout: Layout
    shards: list


@dataclass
class ShardedState:
    layout: Layout
    shards: list


_Y_FIELDS = ("lc", "uc", "lc_fin", "uc_fin", "lc0", "uc0", "lc_orig",
             "uc_orig", "lc0_orig", "uc0_orig", "row_scale")
_X_FIELDS = ("c", "lv", "uv", "lv_fin", "uv_fin", "lv0", "uv0", "c_orig",
             "lv_orig", "uv_orig", "lv0_orig", "uv0_orig", "col_scale")
_Y_STATE = ("y", "ax", "avg_y", "avg_ax", "y_last_restart")
_X_STATE = ("x", "aty", "avg_x", "avg_aty", "x_last_restart")


def _even_splits(n, D):
    base, extra = divmod(n, D)
    sizes = [base + (d < extra) for d in range(D)]
    return tuple(int(v) for v in np.concatenate([[0], np.cumsum(sizes)]))


def _tile_splits(n, tile, D):
    """Splits of n at tile boundaries, the tiles shared as evenly as
    possible (the first shards take one more)."""
    T = -(-n // tile)
    t = _even_splits(T, D)
    return tuple(min(int(v) * tile, n) for v in t)


def make_layout(op, D: int) -> Layout:
    """The layout for `op` on D shards: rows (and columns) at 128-row
    tile boundaries for a block-band operator, so that every shard owns
    whole slabs, and in even blocks otherwise. The x-space is sharded
    when the column count divides by D (cuopt_tpu's rule)."""
    from cuopt_torch.sparse.ops import BlockBandOp, PermutedOp

    n_rows, n_cols = op.shape
    band = op.inner if isinstance(op, PermutedOp) else op
    if isinstance(band, BlockBandOp):
        rows = _tile_splits(n_rows, band.tile, D)
        cols = _tile_splits(n_cols, band.tile, D)
    else:
        rows = _even_splits(n_rows, D)
        cols = _even_splits(n_cols, D)
    return Layout(n_rows, n_cols, rows, cols if n_cols % D == 0 else None)


def shard_problem_and_state(dev, state, mesh: Mesh):
    """Split a built (scaled) DeviceProblem and its SolverState over a
    one-axis mesh. Returns (ShardedProblem, ShardedState)."""
    from cuopt_torch.sparse.ops import shard_operator

    if len(mesh.shape) != 1:
        raise ValueError("PDLP shards over a one-axis mesh")
    D = mesh.size
    layout = make_layout(dev.op, D)
    ops = shard_operator(dev.op, layout, mesh)
    devs, states = [], []
    for d, device in enumerate(mesh.devices):
        r0, r1 = layout.rows(d)
        c0, c1 = layout.cols(d)

        def rows(v):
            return v[r0:r1].to(device)

        def cols(v):
            return v[c0:c1].to(device)

        def rep(v):
            return v.to(device)

        kw = {f: rows(getattr(dev, f)) for f in _Y_FIELDS}
        kw.update({f: cols(getattr(dev, f)) for f in _X_FIELDS})
        devs.append(dataclasses.replace(
            dev, op=ops[d], offset=rep(dev.offset), row_perm=None,
            inv_row_perm=None, col_perm=None, inv_col_perm=None, **kw))
        skw = {f: rows(getattr(state, f)) for f in _Y_STATE}
        skw.update({f: cols(getattr(state, f)) for f in _X_STATE})
        for f in dataclasses.fields(state):
            if f.name not in skw:
                skw[f.name] = rep(getattr(state, f.name))
        states.append(dataclasses.replace(state, **skw))
    return ShardedProblem(mesh, layout, devs), ShardedState(layout, states)


def gather_state(sstate: ShardedState, device=None):
    """The whole SolverState of a sharded one, on `device` (shard 0's by
    default)."""
    s0 = sstate.shards[0]
    device = torch.device(device) if device is not None else s0.x.device
    kw = {}
    for f in dataclasses.fields(s0):
        vals = [getattr(s, f.name) for s in sstate.shards]
        if f.name in _Y_STATE or (f.name in _X_STATE and
                                  sstate.layout.col_splits is not None):
            kw[f.name] = torch.cat([v.to(device) for v in vals])
        else:
            kw[f.name] = vals[0].to(device)
    return dataclasses.replace(s0, **kw)


# report entries that are vectors over rows / over columns
_Y_REPORT = ("y_cur", "y_avg")
_X_REPORT = ("x_cur", "x_avg", "reduced_cost_cur", "reduced_cost_avg")


def sharded_major(major, dev: ShardedProblem, state: ShardedState):
    """Run `major(shard_problem, shard_state) -> (state, report)` on every
    shard under run_spmd. Returns (ShardedState, report) with the report
    whole on shard 0's device: scalars from shard 0 (every shard holds
    the same bits), vectors concatenated in shard order. The report also
    carries "collectives" and "bytes_sent", summed over the shards."""
    def body(comm, d, s):
        d = attach_comm(d, comm)
        s, report = major(d, s)
        return s, report, comm.collectives, comm.bytes_sent

    out = run_spmd(dev.mesh, body, list(zip(dev.shards, state.shards)))
    device = dev.mesh.devices[0]
    reports = [r for _, r, _, _ in out]
    report = dict(reports[0])
    for k in _Y_REPORT + _X_REPORT:
        if k in _Y_REPORT or dev.layout.col_splits is not None:
            report[k] = torch.cat([r[k].to(device) for r in reports])
    report["collectives"] = sum(c for _, _, c, _ in out)
    report["bytes_sent"] = sum(b for _, _, _, b in out)
    return ShardedState(dev.layout, [s for s, _, _, _ in out]), report


def attach_comm(dev, comm: ShardComm):
    """Shard problem `dev` with its operator bound to `comm`."""
    return dataclasses.replace(dev, op=dev.op.bind(comm))
