"""The chunkwise mLSTM (B7) and the xLSTM layers against the JAX
reference. The plain chunkwise version (the kernel's, with its state)
against the reference's ``mlstm_ref`` (the exact recurrent form), its
``mlstm_chunkwise`` and its Pallas kernel in interpret mode on
``tests/test_kernels.py``'s grid — outputs and the final state — plus
what the Pallas kernel does not take (a state in and out, ragged S);
``mlstm_apply`` and ``slstm_apply`` against ``repro.models.xlstm``; the
Hopper kernel's product precision (``mlstm_chunkwise_tc_model``: TF32
hi/lo operand splits) against the plain version and the JAX reference.
Tolerance: 5e-4 abs / 5e-3 rel for the chunkwise form against other
forms, the reference's own (``tests/test_kernels.py:148``); 1e-5 where
both sides compute the same form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_config
from repro.kernels.mlstm.ops import mlstm as j_mlstm
from repro.kernels.mlstm.ref import mlstm_ref as j_mlstm_ref
from repro.models import xlstm as JX

from repro_torch.configs.base import get_config as t_config
from repro_torch.kernels.mlstm import ops as ML
from repro_torch.kernels.mlstm import ref as MR
from repro_torch.models import xlstm as TX

ATOL, RTOL = 5e-4, 5e-3


def _inputs(rng, b, s, h, dk, dv):
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-(rng.standard_normal((b, s, h)) + 2)))
                ).astype(np.float32)
    return q, k, v, li, lf


def _state(rng, b, h, dk, dv):
    return (rng.standard_normal((b, h, dk, dv)).astype(np.float32),
            rng.standard_normal((b, h, dk)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(ours, ref, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [   # tests/test_kernels.py:133
    (2, 128, 2, 32, 64, 32),
    (1, 64, 4, 16, 32, 16),
    (2, 96, 1, 64, 64, 32),
])
def test_plain_mlstm_matches_reference_and_pallas(b, s, h, dk, dv, chunk):
    x = _inputs(np.random.default_rng(s + dk), b, s, h, dk, dv)
    ours, (c, n, m) = ML.mlstm(*_t(x))
    _close(ours, j_mlstm_ref(*_j(x)), what="vs mlstm_ref")
    _close(ours, j_mlstm(*_j(x), chunk=chunk, interpret=True),
           what="vs the Pallas kernel")
    # the Pallas kernel's own chunk, through the plain version
    same, _ = MR.mlstm_chunkwise_ref(*_t(x), chunk=chunk)
    _close(same, j_mlstm(*_j(x), chunk=chunk, interpret=True),
           what=f"chunk {chunk} vs the Pallas kernel")
    _, (jc, jn, jm) = JX.mlstm_recurrent_ref(*_j(x))
    for ours_s, ref_s, name in ((c, jc, "C"), (n, jn, "n"), (m, jm, "m")):
        _close(ours_s, ref_s, what=f"final {name}")


def test_plain_mlstm_matches_the_models_chunkwise_form():
    """tests/test_kernels.py:151-166's case: outputs and the final state
    against ``mlstm_chunkwise`` (chunks of 32)."""
    x = _inputs(np.random.default_rng(7), 2, 128, 2, 16, 32)
    ours, st = ML.mlstm(*_t(x))
    ref, jst = JX.mlstm_chunkwise(*_j(x), chunk=32)
    _close(ours, ref)
    for a, b_ in zip(st, jst):
        _close(a, b_)


@pytest.mark.parametrize("s", [1, 5, 64, 70, 200])
def test_plain_mlstm_takes_any_s_and_a_state(s):
    """S = 1, S < chunk, whole chunks, a ragged last chunk; from a nonzero
    state, against the exact recurrent form from the same state."""
    rng = np.random.default_rng(s)
    x = _inputs(rng, 2, s, 2, 16, 24)
    st = _state(rng, 2, 2, 16, 24)
    st = (st[0], np.abs(st[1]), st[2])
    ours, ost = ML.mlstm(*_t(x), tuple(_t(st)))
    ref, rst = JX.mlstm_recurrent_ref(*_j(x), tuple(_j(st)))
    _close(ours, ref, what="h")
    for a, b_, name in zip(ost, rst, "Cnm"):
        _close(a, b_, what=f"final {name}")


def test_split_sequence_carries_the_state():
    """Two calls, the second from the first's state, equal one call."""
    x = _inputs(np.random.default_rng(3), 2, 150, 2, 16, 32)
    whole, st = ML.mlstm(*_t(x))
    h1, st1 = ML.mlstm(*(t[:, :77] for t in _t(x)))
    h2, st2 = ML.mlstm(*(t[:, 77:] for t in _t(x)), st1)
    torch.testing.assert_close(torch.cat([h1, h2], 1), whole, atol=ATOL,
                               rtol=RTOL)
    for a, b_ in zip(st2, st):
        torch.testing.assert_close(a, b_, atol=ATOL, rtol=RTOL)


def test_plain_recurrent_form_matches_reference():
    rng = np.random.default_rng(4)
    x = _inputs(rng, 2, 9, 3, 8, 12)
    st = _state(rng, 2, 3, 8, 12)
    ours, ost = MR.mlstm_recurrent_ref(*_t(x), tuple(_t(st)))
    ref, rst = JX.mlstm_recurrent_ref(*_j(x), tuple(_j(st)))
    _close(ours, ref, 1e-5, 1e-5)
    for a, b_ in zip(ost, rst):
        _close(a, b_, 1e-5, 1e-5)


def test_gate_runs_the_plain_version_on_the_cpu_and_refuses_cuda():
    x = _t(_inputs(np.random.default_rng(0), 1, 5, 2, 8, 8))
    a, _ = ML.mlstm(*x, backend="ref")
    b_, _ = ML.mlstm(*x)
    torch.testing.assert_close(a, b_, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ML.mlstm(*x, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ML.mlstm_cuda(*x)


# ---------------------------------------------------------------------------
# the kernel's product precision
# ---------------------------------------------------------------------------

def test_tf32_split_rounds_to_nearest_away_and_keeps_21_bits():
    one = np.float32(1.0)
    half = np.float32(1.0 + 2.0 ** -11)      # halfway between two TF32s
    below = np.float32(1.0 + 2.0 ** -12)
    x = torch.tensor([one, half, -half, below, 3.0e-30, -7.5e12])
    hi = MR.tf32_round(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert hi.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                               1.0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    hi, lo = MR.tf32_split(x)
    assert ((x - hi - lo).abs() <= 2.0 ** -21 * x.abs()).all()
    bf = x.bfloat16().float()                # bf16 values are TF32 values
    assert torch.equal(MR.tf32_split(bf)[0], bf)
    assert not MR.tf32_split(bf)[1].any()


def test_tc_einsum_is_near_float32_where_plain_tf32_is_not():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 192)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((192, 32)).astype(np.float32))
    exact = (a.double() @ b.double())
    split = MR.tc_einsum("ik,kj->ij", a, b)
    plain = MR.tf32_round(a) @ MR.tf32_round(b)
    assert float((split.double() - exact).abs().max()) < 1e-4
    assert float((plain.double() - exact).abs().max()) > 1e-3


#: (B, S, H, Dk, Dv, dtype of q/k/v, state): small shapes, then the
#: xLSTM-125M head (Dk 192, Dv 384) at S 70 (a ragged second chunk)
TC_GRID = [(2, 5, 2, 16, 24, "float32", False),
           (1, 64, 2, 32, 40, "bfloat16", True),
           (2, 70, 1, 24, 16, "float32", True),
           (2, 70, 2, 192, 384, "bfloat16", False),
           (2, 70, 2, 192, 384, "float32", True),
           (1, 70, 1, 256, 96, "bfloat16", True)]


@pytest.mark.parametrize("b,s,h,dk,dv,dtype,with_state", TC_GRID)
def test_tc_model_matches_plain_version_and_reference(b, s, h, dk, dv,
                                                      dtype, with_state):
    """The kernel's numerics (q.k^T, W.V, q.C and (k * sc)^T.V as split
    TF32 products) within 5e-4 / 5e-3 of the plain chunkwise version and
    of the JAX reference's exact recurrent form, outputs and final state,
    under ``jax.disable_jit()``."""
    rng = np.random.default_rng(s * dk + b)
    x = list(_inputs(rng, b, s, h, dk, dv))
    if dtype == "bfloat16":    # inputs the kernel gets as bf16
        x[:3] = [np.asarray(torch.from_numpy(a).bfloat16().float())
                 for a in x[:3]]
    st = None
    if with_state:
        st = _state(rng, b, h, dk, dv)
        st = (st[0], np.abs(st[1]), st[2])
    tx = _t(x)
    if dtype == "bfloat16":
        tx[:3] = [a.bfloat16() for a in tx[:3]]
    tst = tuple(_t(st)) if st is not None else None
    ours, ost = MR.mlstm_chunkwise_tc_model(*tx, tst)
    plain, pst = MR.mlstm_chunkwise_ref(*tx, tst)
    for a, r, name in zip((ours,) + ost, (plain,) + pst, "hCnm"):
        torch.testing.assert_close(a, r, atol=ATOL, rtol=RTOL,
                                   msg=f"{name} vs the plain version")
    with jax.disable_jit():
        if st is None:
            ref = j_mlstm_ref(*_j(x))
            _, rst = JX.mlstm_recurrent_ref(*_j(x))
        else:
            ref, rst = JX.mlstm_recurrent_ref(*_j(x), tuple(_j(st)))
    _close(ours, ref, what="h vs the JAX reference")
    for a, r, name in zip(ost, rst, "Cnm"):
        _close(a, r, what=f"final {name} vs the JAX reference")


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _cfgs():
    return (j_config("xlstm_125m").reduced(dtype="float32"),
            t_config("xlstm_125m").reduced(dtype="float32"))


def _params(fn_j, jc, seed):
    p, _ = fn_j(jax.random.PRNGKey(seed), jc)
    p = jax.tree.map(np.asarray, p)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


@pytest.mark.parametrize("s", [1, 9, 70])
def test_mlstm_apply_matches_reference(s):
    """Without a cache, from the empty cache, and one-token decode (the
    recurrent form on both sides) from a carried cache."""
    jc, tc = _cfgs()
    jp, tp = _params(JX.mlstm_params, jc, s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    y_ref, _ = JX.mlstm_apply(jc, jp, jnp.asarray(x))
    y, _ = TX.mlstm_apply(tc, tp, torch.from_numpy(x))
    _close(y, y_ref, what="no cache")
    jcache, _ = JX.mlstm_cache(jc, 2)
    tcache = TX.mlstm_cache(tc, 2, "cpu")
    pre = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    _, jcache = JX.mlstm_apply(jc, jp, jnp.asarray(pre), jcache)
    TX.mlstm_apply(tc, tp, torch.from_numpy(pre), tcache)
    y_ref, jcache = JX.mlstm_apply(jc, jp, jnp.asarray(x), jcache)
    y, tcache = TX.mlstm_apply(tc, tp, torch.from_numpy(x), tcache)
    _close(y, y_ref, what="with a cache")
    for k in ("c", "n", "m"):
        _close(tcache[k], jcache[k], what=k)


@pytest.mark.parametrize("s", [1, 12])
def test_slstm_apply_matches_reference(s):
    """The sequential sLSTM from its initial state (n = 1) and from a
    carried one; float32 on both sides, 1e-5."""
    jc, tc = _cfgs()
    jp, tp = _params(JX.slstm_params, jc, 10 + s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    y_ref, _ = JX.slstm_apply(jc, jp, jnp.asarray(x))
    y, _ = TX.slstm_apply(tc, tp, torch.from_numpy(x))
    _close(y, y_ref, 1e-5, 1e-5, "no cache")
    jcache, _ = JX.slstm_cache(jc, 2)
    tcache = TX.slstm_cache(tc, 2, "cpu")
    for k in jcache:
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(jcache[k]))
    for step in range(2):
        y_ref, jcache = JX.slstm_apply(jc, jp, jnp.asarray(x), jcache)
        y, tcache = TX.slstm_apply(tc, tp, torch.from_numpy(x), tcache)
        _close(y, y_ref, 1e-5, 1e-5, f"with a cache, call {step}")
        for k in ("c", "n", "h", "m"):
            _close(tcache[k], jcache[k], 1e-5, 1e-5, k)
