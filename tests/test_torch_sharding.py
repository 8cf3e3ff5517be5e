"""The port's mesh (cuopt_torch/parallel) against cuopt_tpu's, on the CPU.

The port runs 8 shards on the CPU (`make_mesh(devices=["cpu"] * 8)`),
each in a thread of its own; cuopt_tpu runs its 8-device CPU mesh
(tests/torch_mesh_helpers.py). Sizes and tolerances are those of
cuopt_tpu's tests/test_multichip.py: two float64 majors from one state,
x and y within 1e-9, equal steps, the KKT score within 1e-8.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __import__("os").path.dirname(__file__))
from torch_mesh_helpers import flatten, run_tpu, serve, unflatten  # noqa: E402

import cuopt_torch.lp.pdlp as T  # noqa: E402
from cuopt_torch.parallel import (  # noqa: E402
    gather_state,
    hierarchical_psum,
    make_mesh,
    make_mesh_2d,
    run_spmd,
    shard_problem_and_state,
)
from cuopt_torch.sparse.ops import pack_halos, split_halos  # noqa: E402

CPU8 = ["cpu"] * 8
_SIZES = {"dense": (256, 192), "ell": (1024, 1024),
          "blockband": (2048, 2048), "csr": (1024, 1024)}


# ------------------------------------------------------ cuopt_tpu's side
def _tpu_cfg():
    from cuopt_tpu.lp.hyper_params import PRESETS
    from cuopt_tpu.lp.pdlp import StaticCfg
    from cuopt_tpu.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    hp = PRESETS[s.pdlp_solver_mode]
    t = s.tolerances
    return StaticCfg(
        hp=hp, abs_primal=t.absolute_primal_tolerance,
        rel_primal=t.relative_primal_tolerance,
        abs_dual=t.absolute_dual_tolerance,
        rel_dual=t.relative_dual_tolerance,
        abs_gap=t.absolute_gap_tolerance,
        rel_gap=t.relative_gap_tolerance), hp


def tpu_two_majors(kind):
    """cuopt_tpu: the device problem and initial state of
    tests/test_multichip.py's equality check, and two majors of them on
    its 8-device mesh."""
    import jax.numpy as jnp

    from cuopt_tpu.lp.pdlp import (
        build_device_problem, initial_state, make_major_fn)
    from cuopt_tpu.parallel import make_mesh as j_mesh
    from cuopt_tpu.parallel import shard_problem_and_state as j_shard
    from cuopt_tpu.problem.synthetic import generate_lp

    cfg, hp = _tpu_cfg()
    n_rows, n_cols = _SIZES[kind]
    prob = generate_lp(n_rows, n_cols, 6, seed=3,
                       band=192 if kind == "blockband" else None)
    dev = build_device_problem(prob, hp, jnp.float64, kind)
    state = initial_state(dev, hp, jnp.float64)
    out = flatten("dev", dev, {})
    flatten("state", state, out)
    dev_s, state_s = j_shard(dev, state, j_mesh(8))
    fn = make_major_fn(cfg)
    s8, r8 = fn(dev_s, state_s)
    s8, r8 = fn(dev_s, s8)
    out.update(x=np.asarray(s8.x), y=np.asarray(s8.y),
               steps=np.asarray(s8.total_steps),
               kkt=np.asarray(r8["kkt_cur"]),
               halo=np.asarray(getattr(dev_s.op, "halo_meta", None)
                               is not None))
    for k in ("primal_obj", "dual_obj", "l2_primal_res", "l2_dual_res"):
        out[f"info/{k}"] = np.asarray(r8["info_cur"][k])
    return out


def tpu_halo_attempt():
    """cuopt_tpu: one halo_attempt on its 8-device mesh, from the state
    after one unsharded major of the 2048 block-band LP."""
    import jax.numpy as jnp

    from cuopt_tpu.lp.pdlp import (
        build_device_problem, initial_state, make_major_fn)
    from cuopt_tpu.parallel import make_mesh as j_mesh
    from cuopt_tpu.parallel import shard_problem_and_state as j_shard
    from cuopt_tpu.problem.synthetic import generate_lp
    from cuopt_tpu.sparse.ops import halo_attempt

    cfg, hp = _tpu_cfg()
    prob = generate_lp(2048, 2048, 6, seed=3, band=192)
    dev = build_device_problem(prob, hp, jnp.float64, "blockband")
    state, _ = make_major_fn(cfg)(dev, initial_state(dev, hp, jnp.float64))
    out = flatten("dev", dev, {})
    flatten("state", state, out)
    dev_s, st = j_shard(dev, state, j_mesh(8))
    assert dev_s.op.halo_meta is not None
    eta, omega = st.step_size, st.primal_weight
    tau, sigma = eta / omega, eta * omega
    sent = jnp.finfo(jnp.float64).max / 8.0 / jnp.maximum(sigma, 1.0)
    lc0m = jnp.where(dev_s.lc_fin, dev_s.lc0, -sent)
    uc0m = jnp.where(dev_s.uc_fin, dev_s.uc0, sent)
    res = halo_attempt(dev_s.op, st.x, st.aty, dev_s.c, dev_s.lv, dev_s.uv,
                       st.ax, st.y, lc0m, uc0m, tau, sigma, omega)
    for k, v in zip(("x_new", "y_new", "ax_new", "aty_new", "sums"), res):
        out[k] = np.asarray(v)
    out["halo_meta"] = np.asarray(dev_s.op.halo_meta)
    return out


# ---------------------------------------------------------- port's side
def _port_start(flat):
    dev = T.device_problem_from_arrays(unflatten(flat, "dev"), "cpu")
    state = T.state_from_arrays(unflatten(flat, "state"), "cpu")
    return dev, state


def _cfg_from_settings():
    from cuopt_torch.lp.hyper_params import PRESETS
    from cuopt_torch.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    t = s.tolerances
    return T.StaticCfg(
        hp=PRESETS[s.pdlp_solver_mode],
        abs_primal=t.absolute_primal_tolerance,
        rel_primal=t.relative_primal_tolerance,
        abs_dual=t.absolute_dual_tolerance,
        rel_dual=t.relative_dual_tolerance,
        abs_gap=t.absolute_gap_tolerance,
        rel_gap=t.relative_gap_tolerance)


def _close(a, b, tol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind", ["dense", "ell", "blockband", "csr"])
def test_sharded_major_matches(kind):
    """Two float64 majors on 8 shards equal cuopt_tpu's 8-device mesh and
    the port's unsharded majors from the same state."""
    flat = run_tpu(__file__, tpu_two_majors, kind)
    dev, state = _port_start(flat)
    fn = T.make_major_fn(_cfg_from_settings())
    s1, r1 = fn(dev, state)
    s1, r1 = fn(dev, s1)
    mesh = make_mesh(devices=CPU8)
    dev8, st8 = shard_problem_and_state(dev, state, mesh)
    assert len(dev8.shards) == 8 and all(
        type(d.op).__name__.startswith("Sharded") for d in dev8.shards)
    st8, r8 = fn(dev8, st8)
    st8, r8 = fn(dev8, st8)
    s8 = gather_state(st8)
    for want in (s1, flat):
        get = want.get if isinstance(want, dict) else \
            lambda k: getattr(want, k)
        _close(s8.x, get("x"))
        _close(s8.y, get("y"))
    assert int(s8.total_steps) == int(s1.total_steps) == int(flat["steps"])
    for want in (float(r1["kkt_cur"]), float(flat["kkt"])):
        np.testing.assert_allclose(float(r8["kkt_cur"]), want, rtol=1e-8)
    for k in ("primal_obj", "dual_obj", "l2_primal_res", "l2_dual_res"):
        np.testing.assert_allclose(float(r8["info_cur"][k]),
                                   float(flat[f"info/{k}"]), rtol=1e-8,
                                   atol=1e-10)
    # the report's vectors come back whole
    assert r8["x_cur"].shape == s1.x.shape and r8["y_cur"].shape == \
        s1.y.shape
    if kind == "blockband":
        # the slabs are split, not replicated, and both packages took the
        # single-exchange attempt
        rows = [d.op.row_slabs.shape[0] for d in dev8.shards]
        assert rows == [dev.op.row_slabs.shape[0] // 8] * 8
        assert dev8.shards[0].op.halo_meta is not None and bool(flat["halo"])
    if kind == "csr":
        # each shard holds 1/8 of the nonzeros, padded to a multiple of 8
        nnz = [d.op.csr_vals.shape[0] for d in dev8.shards]
        assert len(set(nnz)) == 1 and nnz[0] * 8 >= dev.op.csr_vals.shape[0]


def test_halo_attempt_matches():
    """One single-exchange attempt on 8 shards equals cuopt_tpu's on the
    same inputs: the iterates, the products and the five packed sums."""
    from cuopt_torch.sparse.ops import halo_attempt

    flat = run_tpu(__file__, tpu_halo_attempt)
    dev, state = _port_start(flat)
    dev8, st8 = shard_problem_and_state(dev, state, make_mesh(devices=CPU8))
    meta = dev8.shards[0].op.halo_meta
    assert meta is not None and tuple(meta) == tuple(flat["halo_meta"])
    D, Lr, Lc, Hx, Hy, ty = meta
    assert Hx > 0 and Hy > 0

    def body(comm, d, s):
        op = d.op.bind(comm)
        eta, omega = s.step_size, s.primal_weight
        tau, sigma = eta / omega, eta * omega
        sent = torch.finfo(torch.float64).max / 8.0 / sigma.clamp(min=1.0)
        lc0m = torch.where(d.lc_fin, d.lc0, -sent)
        uc0m = torch.where(d.uc_fin, d.uc0, sent)
        out = halo_attempt(op, s.x, s.aty, d.c, d.lv, d.uv, s.ax, s.y,
                           lc0m, uc0m, tau, sigma, omega)
        return out, comm.collectives

    outs = run_spmd(dev8.mesh, body, list(zip(dev8.shards, st8.shards)))
    for i, k in enumerate(("x_new", "y_new", "ax_new", "aty_new")):
        _close(torch.cat([o[0][i] for o in outs]), flat[k], 1e-12)
    for o in outs:  # every shard holds the same sums
        assert torch.equal(o[0][4], outs[0][0][4])
    np.testing.assert_allclose(outs[0][0][4].numpy(), flat["sums"],
                               rtol=1e-12)
    # 2 ppermutes + 1 packed psum per attempt
    assert {o[1] for o in outs} == {3}


def test_zero_halo_packing():
    """No operator passes the halo gates with Hx == 0 < Hy: the boundary
    tile between shards d and d + 1 would need its window inside both of
    their column blocks. So the pack-and-split helper is held directly.
    With Hx == 0 the port packs no x-space halo and the y halos come out
    whole. cuopt_tpu's slicing (sparse/ops.py:595, ADVICE r05) writes
    v[-Hx:], which for Hx == 0 is the whole vector: its split then reads
    x data as the y halos, as the second half shows."""
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.normal(size=12)) for _ in range(5)]
    ys = [torch.as_tensor(rng.normal(size=10)) for _ in range(4)]
    Hx, Hy = 0, 3
    for side in ("tail", "head"):
        buf = pack_halos(xs, ys, Hx, Hy, side)
        assert buf.numel() == 4 * Hy
        parts = split_halos(buf, 5, 4, Hx, Hy)
        assert all(p.numel() == 0 for p in parts[:5])
        for p, v in zip(parts[5:], ys):
            want = v[len(v) - Hy:] if side == "tail" else v[:Hy]
            assert torch.equal(p, want)
    # cuopt_tpu's form of the same pack, split as its halo_attempt splits
    ref = torch.cat([v[-Hx:] for v in xs] + [v[-Hy:] for v in ys])
    assert ref.numel() == 5 * 12 + 4 * Hy  # the x vectors ride whole
    ref_parts = split_halos(ref, 5, 4, Hx, Hy)
    assert torch.equal(ref_parts[5], xs[0][:Hy])  # an x value as y's halo
    assert not torch.equal(ref_parts[5], ys[0][-Hy:])


def test_hierarchical_psum_on_two_axes():
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    assert mesh.shape == (2, 4) and mesh.axis_names == ("slices", "rows")
    x = torch.as_tensor(np.random.default_rng(0).normal(size=4096))
    got = float(hierarchical_psum(x, mesh))
    np.testing.assert_allclose(got, float(x.sum()), rtol=1e-12)
    # the two stages: four partials inside each slice, then the slices
    parts = x.chunk(8)
    want = sum(sum(float(p.sum()) for p in parts[s * 4:(s + 1) * 4])
               for s in range(2))
    np.testing.assert_allclose(got, want, rtol=1e-15)


if __name__ == "__main__":
    serve(globals())
