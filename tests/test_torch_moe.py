"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference: the capacity formula at the full configs, the dispatch with
drops, all-tie routing and a small capacity factor, the grouped dispatch
under a mesh with a ``data`` axis, and one bfloat16 case run op by op.
Tolerance: 1e-5 in float32 on the output and the aux loss; 2e-2 in
bfloat16 (the reference under ``jax.disable_jit()``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import moe as JMOE

from repro_torch.configs.base import get_config
from repro_torch.models import moe as MOE
from repro_torch.sharding import Mesh, sharding_ctx

ARCHS = ("olmoe_1b_7b", "grok_1_314b")


def _cfgs(arch="olmoe_1b_7b", **kw):
    kw.setdefault("dtype", "float32")
    return (j_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


def _inputs(cfg, seed, shape=(2, 32, 64), zero_router=False):
    """Seeded parameters in the reference's layout and an input, as numpy
    float32 (cast to the config's dtype on each side)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if zero_router:
        p["router"] = np.zeros((d, e))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal(shape).astype(np.float32)
    return p, x


def _pair(cfg, p, x):
    """The same parameters and input for both packages (router float32,
    the rest in the config's dtype)."""
    jd, td = jnp.dtype(cfg.dtype), getattr(torch, cfg.dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jd)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else td)
          for k, v in p.items()}
    return jp, tp, jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(ours, ref, tol, what):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [1, 2, 7, 64, 512, 1024, 2048, 4096])
def test_capacity_matches_reference_at_full_configs(arch, tokens):
    jc, tc = j_get_config(arch), get_config(arch)
    assert MOE.capacity(tc, tokens) == JMOE.capacity(jc, tokens)


def test_capacity_at_the_serve_shapes():
    olmoe, grok = get_config("olmoe_1b_7b"), get_config("grok_1_314b")
    assert MOE.capacity(olmoe, 2) == 8        # decode: nothing dropped
    assert MOE.capacity(olmoe, 2048) == 384   # prefill of 2 x 1024
    assert MOE.capacity(grok, 1024) == 384    # prefill of 2 x 512
    assert MOE.capacity(grok, 2) == 8


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.full((3, 8), 1 / 8)
    probs[1, 5] = 0.5
    probs[2] = torch.tensor([0.1, 0.3, 0.1, 0.3, 0.0, 0.1, 0.1, 0.0])
    vals, idx = MOE.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx[0].tolist() == [0, 1, 2]


@pytest.mark.parametrize("case", [
    dict(seed=0),
    dict(seed=1, zero_router=True),   # all ties: 64 assignments an expert, 40 kept
    dict(seed=2, capacity_factor=0.5),
    dict(seed=3, arch="grok_1_314b"),
])
def test_moe_apply_matches_reference(case):
    case = dict(case)
    seed, zero = case.pop("seed"), case.pop("zero_router", False)
    jc, tc = _cfgs(**case)
    p, x = _inputs(tc, seed, zero_router=zero)
    jp, tp, jx, tx = _pair(tc, p, x)
    jy, jaux = JMOE.moe_apply(jc, jp, jx)
    ty, taux = MOE.moe_apply(tc, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, 1e-5, "output")
    _close(taux, jaux, 1e-5, "aux loss")
    if zero:
        # every token routes to experts 0 and 1; past capacity 40 the
        # last 24 tokens of 64 lose both, so their output is zero
        assert MOE.capacity(tc, 64) == 40
        flat = ty.reshape(64, -1)
        assert torch.count_nonzero(flat[40:]) == 0
        assert torch.count_nonzero(flat[:40].abs().sum(-1)) == 40


@pytest.mark.parametrize("data", [2, 4])
def test_grouped_dispatch_matches_reference(data):
    """Under a mesh with a ``data`` axis of ``data`` entries each group of
    batch rows dispatches on its own (own capacity, so other drops), and
    the aux losses average: the reference's ``jax.vmap`` of
    ``_moe_apply_dense(..., in_manual=True)`` over the groups."""
    jc, tc = _cfgs(capacity_factor=0.5)
    p, x = _inputs(tc, 10 + data, shape=(4, 16, 64))
    jp, tp, jx, tx = _pair(tc, p, x)
    xg = jx.reshape(data, 4 // data, *jx.shape[1:])
    jy, jaux = jax.vmap(lambda xb: JMOE._moe_apply_dense(
        jc, jp, xb, in_manual=True))(xg)
    mesh = Mesh(np.array(["cpu"] * data).reshape(data, 1), ("data", "model"))
    with sharding_ctx(mesh):
        ty, taux = MOE.moe_apply(tc, tp, tx)
    _close(ty, jy.reshape(jx.shape), 1e-5, "grouped output")
    _close(taux, jnp.mean(jaux), 1e-5, "grouped aux loss")
    # a batch the groups do not divide takes the global dispatch
    with sharding_ctx(Mesh(np.array(["cpu"] * 3).reshape(3, 1),
                           ("data", "model"))):
        with pytest.raises(NotImplementedError, match="shard_act"):
            MOE.moe_apply(tc, tp, tx)
    gy, _ = MOE.moe_apply(tc, tp, tx)
    assert not torch.allclose(gy, ty, atol=1e-5)   # the groups mattered


def test_moe_apply_bf16_matches_reference_op_by_op():
    jc, tc = _cfgs(dtype="bfloat16")
    p, x = _inputs(tc, 5)
    jp, tp, jx, tx = _pair(tc, p, x)
    with jax.disable_jit():
        jy, jaux = JMOE.moe_apply(jc, jp, jx)
    ty, taux = MOE.moe_apply(tc, tp, tx)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, 2e-2, "bf16 output")
    _close(taux, jaux, 1e-5, "bf16 aux loss (float32 router)")


def test_moe_params_shapes_and_dtypes():
    _, tc = _cfgs(dtype="bfloat16")
    p = MOE.moe_params(torch.Generator().manual_seed(0), tc)
    meta = MOE.moe_params(None, tc)
    e, d, f = tc.num_experts, tc.d_model, tc.d_ff
    want = {"router": ((d, e), torch.float32),
            "w_gate": ((e, d, f), torch.bfloat16),
            "w_up": ((e, d, f), torch.bfloat16),
            "w_down": ((e, f, d), torch.bfloat16)}
    for k, (shape, dtype) in want.items():
        assert tuple(p[k].shape) == shape and p[k].dtype == dtype, k
        assert tuple(meta[k].shape) == shape and meta[k].is_meta, k
