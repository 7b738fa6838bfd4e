"""``Model.loss`` of the port against the reference's for every arch
(``reduced()``, float32): every metric, and every gradient leaf against
``jax.value_and_grad``, with the reference's weights carried across by
``params_from_numpy`` (the VLM's gates and the ungated MLP's biases drawn
non-zero) and gradients mapped back under the same names. The MoE archs
carry their aux loss, Whisper its frames through the encoder, the VLM
its image embeddings; S 40 passes Danube's sliding window (32) and the
hybrid's local window (16). Six archs are here; the other four and the
remat cases are in ``test_torch_train_model_b.py``, the bf16 case in
``test_torch_train_model_bf16.py`` (the files spread over workers).

Tolerances: metrics within rtol 1e-5 (atol 1e-6); each gradient leaf
within 1e-4 of that leaf's max |g| (float32; the two frameworks sum in
other orders, and the recurrent archs' scans associate differently). The
bf16 case (Qwen3, the reference op by op under ``jax.disable_jit()``):
metrics within 2e-2, gradient leaves within 5e-2 of their max |g| (a
bf16 step is 2^-8 of a value, and a gradient sums many of them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as JCFG
from repro.models.model import build_model as j_build

from repro_torch.configs import base as TCFG
from repro_torch.models.model import build_model, params_from_numpy

from test_torch_model import (memory_inputs, nonzero_gates_and_biases,
                              to_torch)

METRICS = ("loss", "ce", "aux_loss", "zloss")
MTOL = {"float32": 1e-5, "bfloat16": 2e-2}
GTOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 40


def loss_case(arch, dtype="float32", seed=0, **kw):
    """(reference (metrics, grads as the port's state dict), the port's
    (metrics, grads)) for one batch, both from the same weights."""
    jc = JCFG.get_config(arch).reduced(dtype=dtype, **kw)
    tc = TCFG.get_config(arch).reduced(dtype=dtype, **kw)
    jm = j_build(jc)
    tree = nonzero_gates_and_biases(jax.tree.map(
        np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(seed))), seed)
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size, (B, S))
    batch = {"tokens": toks.astype(np.int32),
             **memory_inputs(jc, B, seed=seed + 1)}
    vg = jax.value_and_grad(jm.loss, has_aux=True)
    if dtype == "bfloat16":
        with jax.disable_jit():
            (_, jmet), jg = vg(jax.tree.map(jnp.asarray, tree),
                               {k: jnp.asarray(a) for k, a in batch.items()})
    else:
        (_, jmet), jg = jax.jit(vg)(tree, batch)
    jgrads = params_from_numpy(jax.tree.map(np.asarray, jg), tc, "cpu")
    tm = build_model(tc, "cpu")
    tm.load_params(params_from_numpy(tree, tc, "cpu"))
    tm.requires_grad_(True)
    total, tmet = tm.loss({k: to_torch(a) for k, a in batch.items()})
    total.backward()
    tmet = {k: v.detach() for k, v in tmet.items()}
    tgrads = {k: p.grad for k, p in tm.named_parameters()}
    return (jmet, jgrads), (tmet, tgrads)


def check_loss_case(arch, dtype="float32", **kw):
    (jmet, jg), (tmet, tg) = loss_case(arch, dtype, **kw)
    for k in METRICS:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=MTOL[dtype], atol=1e-6, err_msg=k)
    assert tg.keys() == jg.keys()
    for k, g in tg.items():
        r = jg[k].float()
        scale = float(r.abs().max())
        err = float((g.float() - r).abs().max())
        assert err <= GTOL[dtype] * scale + 1e-7, (k, err, scale)
    return jmet, tmet


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "olmoe_1b_7b",
                                  "grok_1_314b", "h2o_danube_1_8b",
                                  "qwen1_5_110b", "granite_3_8b"])
def test_loss_and_grads_match_reference(arch):
    jmet, _ = check_loss_case(arch)
    if arch in ("olmoe_1b_7b", "grok_1_314b"):
        assert float(jmet["aux_loss"]) > 0
