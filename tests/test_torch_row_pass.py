"""cuopt_torch's fused PDHG row pass against cuopt_tpu's Pallas pass.

On CPU tensors the port's `fused_row_pass` runs the plain PyTorch version
of its CUDA kernels; cuopt_tpu's runs its Pallas kernels in interpreter
mode. Both see the same operator (the port's is built from cuopt_tpu's
arrays) and the same inputs. The "partials" mode is held against
cuopt_tpu's streamed variant, forced the way
tests/test_pdhg_pallas.py::test_fused_stream_variant_matches_xla forces
it. Tolerances are those of tests/test_pdhg_pallas.py (:77-83): f32 sums
taken in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import cuopt_torch.lp.pdhg_fused as tf  # noqa: E402
import cuopt_tpu.lp.pdhg_pallas as jp  # noqa: E402
from cuopt_torch.sparse.ops import operator_from_arrays  # noqa: E402
from cuopt_tpu.problem.mittelmann import GENERATORS  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp  # noqa: E402
from cuopt_tpu.sparse import build_operator  # noqa: E402
from cuopt_tpu.sparse.reorder import permute_csr  # noqa: E402

torch.set_num_threads(1)


def _mk(case):
    """cuopt_tpu f32 BlockBandOp of one of the test_pdhg_pallas.py `_mk`
    cases, plus a wide-window one (degen-transport, W=2048, with spill)."""
    if case == "wide":
        p = GENERATORS["degen-transport"](632, 0)
        op = build_operator(p.offsets, p.indices, p.values, p.n_constraints,
                            p.n_variables, dtype=jnp.float32,
                            kind="blockband")
        assert op.w_row == 2048 and op.spill_vals.shape[0] > 0
        return op
    n_rows, n_cols, band, shuffle = {
        "banded": (1000, 900, 64, False),
        "shuffled": (1024, 1024, 96, True),
        "band192": (1024, 1024, 192, False),
    }[case]
    prob = generate_lp(n_rows, n_cols, 6, seed=5, band=band)
    offsets, indices, values = prob.offsets, prob.indices, prob.values
    if shuffle:
        rng = np.random.default_rng(9)
        rp, cp = rng.permutation(n_rows), rng.permutation(n_cols)
        offsets, indices, values = permute_csr(
            np.asarray(offsets), np.asarray(indices),
            np.asarray(values, np.float64), rp, cp, n_rows, n_cols)
    op = build_operator(offsets, indices, values, n_rows, n_cols,
                        dtype=jnp.float32,
                        kind="bandperm" if shuffle else "blockband")
    return op.inner if hasattr(op, "inner") else op


def _port_op(j_op):
    d = {"kind": "BlockBandOp"}
    for f in dataclasses.fields(j_op):
        if f.name in ("mesh", "ext_row_slabs", "ext_row_starts",
                      "halo_meta"):
            continue
        v = getattr(j_op, f.name)
        d[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return operator_from_arrays(d, "cpu")


def _inputs(n, m):
    rng = np.random.default_rng(0)
    x_new = rng.normal(size=m).astype(np.float32)
    ax_old = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    lc = rng.normal(size=n)
    uc = lc + np.abs(rng.normal(size=n))
    lc0m = np.where(rng.random(n) > 0.3, lc, -1e30).astype(np.float32)
    uc0m = np.where(rng.random(n) > 0.3, uc, 1e30).astype(np.float32)
    return x_new, ax_old, y, lc0m, uc0m, np.float32(0.37)


_CASES = ["banded", "shuffled", "band192", "wide"]


@pytest.mark.parametrize("mode", ["atomic", "partials"])
@pytest.mark.parametrize("case", _CASES)
def test_row_pass_matches_pallas(case, mode, monkeypatch):
    j_op = _mk(case)
    t_op = _port_op(j_op)
    assert tf.fused_pass_supported(t_op, torch.float32)
    if mode == "partials":
        monkeypatch.setattr(jp, "_VMEM_RESIDENT_LIMIT", 1)  # force stream
    n, m = j_op.shape
    args = _inputs(n, m)
    j_out = jp.fused_row_pass(j_op, *(jnp.asarray(a) for a in args),
                              interpret=True)
    t_out = tf.fused_row_pass(t_op, *(torch.as_tensor(a) for a in args),
                              mode=mode)
    names = ("ax", "y", "aty")
    for name, a, b in zip(names, t_out[:3], j_out[:3]):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float32 and a.shape == b.shape, name
        err = np.max(np.abs(a - b)) / (1 + np.max(np.abs(b)))
        assert err < 1e-5, (name, err)
    for a, b in zip(t_out[3:], j_out[3:]):
        a, b = float(a), float(b)
        assert abs(a - b) < 1e-3 * (1 + abs(b)), (a, b)


@pytest.mark.parametrize("case", ["shuffled", "wide"])
def test_modes_agree(case):
    """Both modes compute the same pass; only the order of the A^T y sum
    differs."""
    t_op = _port_op(_mk(case))
    args = [torch.as_tensor(a) for a in _inputs(*t_op.shape)]
    a = tf.fused_row_pass(t_op, *args, mode="atomic")
    b = tf.fused_row_pass(t_op, *args, mode="partials")
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-5)


def test_mode_follows_cuopt_tpu_threshold(monkeypatch):
    t_op = _port_op(_mk("banded"))
    assert tf.pick_mode(t_op) == "atomic"
    monkeypatch.setattr(tf, "PARTIALS_MIN_COLS", 1)
    assert tf.pick_mode(t_op) == "partials"


def test_plain_version_only_for_cpu_tensors():
    """A CPU call takes the plain version and launches nothing; a tensor
    on any other device than CPU or CUDA is refused, never computed by
    the plain version."""
    t_op = _port_op(_mk("banded"))
    args = [torch.as_tensor(a) for a in _inputs(*t_op.shape)]
    tf.reset_counts()
    tf.fused_row_pass(t_op, *args)
    assert tf.PlainCount.calls == 1
    assert all(k.launches == 0 for k in tf.KERNELS)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        tf.row_pass(t_op, meta[0], meta[1], None, *meta[2:])
    assert tf.PlainCount.calls == 1


def test_gate():
    t_op = _port_op(_mk("wide"))
    assert tf.fused_pass_supported(t_op, torch.float32)
    assert not tf.fused_pass_supported(t_op, torch.float64)
    assert not tf.fused_pass_supported(object(), torch.float32)


@pytest.mark.parametrize("case", _CASES)
def test_plan_lists_each_column_blocks_contributors(case):
    """The partials kernel's folded tail trusts the plan: a column block
    is complete once as many tiles as cb_offsets lists have counted into
    it. Recount here, from the window starts alone, which tiles' windows
    touch each column block, in tile order."""
    t_op = _port_op(_mk(case))
    p = tf.plan(t_op)
    T, WB = len(t_op.row_starts), t_op.w_row // 128
    n_blocks = -(-t_op.n_cols // 128)
    first = np.asarray(t_op.row_starts) // 128
    want = [[t * WB + cb - first[t] for t in range(T)
             if first[t] <= cb < first[t] + WB] for cb in range(n_blocks)]
    offsets = p.cb_offsets.numpy()
    rows = p.cb_rows.numpy()
    assert p.n_blocks == n_blocks and offsets[0] == 0
    assert np.array_equal(np.diff(offsets), [len(w) for w in want])
    for cb in range(n_blocks):
        assert rows[offsets[cb]:offsets[cb + 1]].tolist() == want[cb]
    assert np.array_equal(p.cb_of_row.numpy(),
                          np.repeat(np.arange(n_blocks), np.diff(offsets)))
    assert p.covered == all(want)
    assert p.counters.dtype == torch.int32 and not p.counters.any()


@pytest.mark.parametrize("case", _CASES)
def test_reference_reduction_adds_in_list_order(case):
    """The kernel sums each column block's parts one after another in
    the plan's list order; reduce_partials_reference (index_add_ on the
    CPU) must give exactly those bits, here summed by hand in float32."""
    t_op = _port_op(_mk(case))
    p = tf.plan(t_op)
    args = [torch.as_tensor(a) for a in _inputs(*t_op.shape)]
    _, _, parts = tf.row_pass_partials_reference(t_op, args[0], args[1],
                                                 None, *args[2:])
    rows = parts.reshape(-1, 128).numpy()
    offsets, listed = p.cb_offsets.numpy(), p.cb_rows.numpy()
    want = np.zeros((p.n_blocks, 128), np.float32)
    for cb in range(p.n_blocks):
        for e in range(offsets[cb], offsets[cb + 1]):
            want[cb] += rows[listed[e]]
    got = tf.reduce_partials_reference(t_op, parts).numpy()
    assert np.array_equal(got, want.reshape(-1)[:t_op.n_cols])


@pytest.mark.parametrize("mode", ["atomic", "partials"])
def test_kernel_check_helper_on_cpu(mode):
    """The check chip_smoke.py and tests/test_torch_gpu.py run on the card,
    here with the plain version on both sides."""
    from cuopt_torch.kernels.checks import check_row_pass, row_pass_inputs

    t_op = _port_op(_mk("wide"))
    out = check_row_pass(t_op, mode, row_pass_inputs(t_op, seed=1))
    assert out["ok"] and out["max_abs_err"] == 0.0
    assert out.get("deterministic", True) and out.get("folded_exact", True)
