"""The port's SPMD runner (cuopt_torch/parallel/sharding.py run_spmd and
ShardComm) and its dry run of every distribution axis, on the CPU: an
error in one shard reaches the caller, shards that part ways raise
instead of hanging, a mesh never picks the CPU or fewer shards on its
own, and every shard gets the same bits from each collective.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from cuopt_torch.parallel import make_mesh, make_mesh_2d, run_spmd
from cuopt_torch.parallel.sharding import ShardDivergence

CPU8 = ["cpu"] * 8


def test_shard_exception_reaches_the_caller():
    """An error in shard 3 aborts the rendezvous that the others wait at
    and is raised in the caller, well within 10 s."""
    mesh = make_mesh(devices=CPU8)

    def body(comm):
        if comm.rank == 3:
            raise ValueError("shard 3 failed")
        for _ in range(5):
            comm.psum(torch.ones(()))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 3 failed"):
        run_spmd(mesh, body, [()] * 8)
    assert time.perf_counter() - t0 < 10.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-shard-")]


def test_shards_at_different_collectives_raise():
    """Shards that part ways raise instead of waiting for each other."""
    mesh = make_mesh(devices=["cpu"] * 4)

    def body(comm):
        t = torch.ones(3)
        return comm.pmax(t) if comm.rank == 2 else comm.psum(t)

    with pytest.raises(ShardDivergence):
        run_spmd(mesh, body, [()] * 4)

    def early(comm):  # shard 1 returns while the others wait
        if comm.rank != 1:
            comm.psum(torch.ones(()))

    t0 = time.perf_counter()
    with pytest.raises(ShardDivergence):
        run_spmd(mesh, early, [()] * 4)
    assert time.perf_counter() - t0 < 10.0


def test_a_mesh_needs_its_cards():
    """make_mesh(n) takes n CUDA cards and raises with fewer; nothing
    falls back to the CPU or to fewer shards."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh(have + 1)
    if have < 2:
        with pytest.raises(RuntimeError, match="CUDA cards"):
            make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_mesh(devices=[f"cuda:{have}"])
    if have == 0:
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh_2d(2, 2)
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    assert make_mesh(devices=["cpu"] * 2).devices == (torch.device("cpu"),) * 2


def test_collectives_give_every_shard_the_same_bits():
    """16 shards (more than this machine's cores), 200 rounds of random
    parts with a 10 us switch interval: psum is the left-to-right sum in
    shard order on every shard, all_gather the parts in order, ppermute
    the ring neighbour's part."""
    D = 16
    mesh = make_mesh(devices=["cpu"] * D)
    rounds = 200

    def body(comm):
        rng = np.random.default_rng(comm.rank)
        got = []
        for _ in range(rounds):
            t = torch.as_tensor(rng.normal(size=7) * 10.0 ** rng.integers(
                -8, 8))
            s = comm.psum(t)
            g = comm.all_gather(t)
            r = comm.ppermute(t, [(i, (i + 1) % D) for i in range(D)])
            got.append((t, s, g, r))
        return got

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = run_spmd(mesh, body, [()] * D)
    finally:
        sys.setswitchinterval(interval)
    for k in range(rounds):
        parts = [out[d][k][0] for d in range(D)]
        want = parts[0]
        for p in parts[1:]:
            want = want + p
        for d in range(D):
            _, s, g, r = out[d][k]
            assert torch.equal(s, want)
            assert torch.equal(g, torch.cat(parts))
            assert torch.equal(r, parts[(d - 1) % D])


def test_dryrun_on_four_cpu_shards():
    from cuopt_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, ["cpu"] * 4)
    assert out["shards"] == 4 and out["rows"]["steps"] > 0
    assert out["rows"]["halo"]
    assert out["batch"] == ["Optimal"] * 4
    assert out["islands"]["best"] <= out["islands"]["construction"]
    assert out["mesh2d"]["shape"] == [2, 2]
