"""The RG-LRU recurrence (B6) and the RG-LRU layer against the JAX
reference. The plain version (the sequential loop the kernel is held to
bitwise on the card) against the reference's ``rg_lru_ref`` and its
Pallas kernel in interpret mode on ``tests/test_kernels.py``'s grid, and
against the model's associative scan; ``rglru_apply`` (prefill with and
without a cache, one-token decode) against ``repro.models.recurrent``.
Tolerance 1e-5 in float32, as ``tests/test_kernels.py:118-126`` holds the
reference's own scan (the sums are taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_config
from repro.kernels.rg_lru.ops import rg_lru as j_rg_lru
from repro.kernels.rg_lru.ref import rg_lru_ref as j_rg_lru_ref
from repro.models import recurrent as JR

from repro_torch.configs.base import get_config as t_config
from repro_torch.kernels.rg_lru import ops as RG
from repro_torch.models import recurrent as TR

TOL = 1e-5


def _inputs(rng, b, s, w, a_hi=0.999):
    a = rng.uniform(0.8, a_hi, (b, s, w)).astype(np.float32)
    x = (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, x, h0


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("b,s,w,bt,bw", [   # tests/test_kernels.py:101-104
    (2, 64, 256, 16, 128),
    (1, 128, 128, 32, 64),
    (3, 48, 384, 16, 128),
])
def test_plain_rg_lru_matches_reference_and_pallas(b, s, w, bt, bw):
    a, x, h0 = _inputs(np.random.default_rng(s + w), b, s, w)
    ours = RG.rg_lru(*_t(a, x, h0))
    ref = j_rg_lru_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    pallas = j_rg_lru(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                      bw=bw, bt=bt, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,s,w,a_hi", [
    (2, 33, 65, 0.999),      # odd S and W (the Pallas kernel needs tiles)
    (1, 1, 7, 0.999),        # one step
    (2, 40, 24, 1.0),        # a ~ 1: the state barely decays
])
def test_plain_rg_lru_odd_shapes_and_slow_decay(b, s, w, a_hi):
    a, x, h0 = _inputs(np.random.default_rng(w), b, s, w, a_hi)
    ours = RG.rg_lru(*_t(a, x, h0))
    ref = j_rg_lru_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_rglru_scan_matches_the_models_associative_scan():
    rng = np.random.default_rng(5)
    a = rng.uniform(0.8, 0.999, (2, 32, 64)).astype(np.float32)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    for init in (None, h0):
        ours = TR.rglru_scan(*_t(a, x), None if init is None else _t(init)[0])
        ref = JR.rglru_scan(jnp.asarray(a), jnp.asarray(x),
                            None if init is None else jnp.asarray(init))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)


def test_gate_runs_the_plain_version_on_the_cpu_and_refuses_cuda():
    a, x, h0 = _t(*_inputs(np.random.default_rng(0), 1, 5, 8))
    torch.testing.assert_close(RG.rg_lru(a, x, h0, backend="ref"),
                               RG.rg_lru(a, x, h0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        RG.rg_lru(a, x, h0, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        RG.rg_lru_cuda(a, x, h0)
    with pytest.raises(ValueError, match="backend"):
        RG.rg_lru(a, x, h0, backend="pallas")


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer(seed=0):
    jc = j_config("recurrentgemma_2b").reduced(dtype="float32")
    tc = t_config("recurrentgemma_2b").reduced(dtype="float32")
    p, _ = JR.rglru_params(jax.random.PRNGKey(seed), jc)
    p = jax.tree.map(np.asarray, p)
    return jc, tc, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(ours, ref):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [1, 9, 40])
def test_rglru_apply_matches_reference(s):
    """Without a cache, from a nonzero cache, and the one-token decode
    fast path (s = 1 with a cache); the new cache too."""
    jc, tc, jp, tp = _layer(s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    cache = {"h": rng.standard_normal((2, jc.lru_width)).astype(np.float32),
             "conv": rng.standard_normal(
                 (2, jc.conv1d_width - 1, jc.lru_width)).astype(np.float32)}
    jpj = {k: jnp.asarray(v) for k, v in jp.items()}
    y_ref, _ = JR.rglru_apply(jc, jpj, jnp.asarray(x))
    y, none = TR.rglru_apply(tc, tp, torch.from_numpy(x))
    assert none is None
    _close(y, y_ref)
    y_ref, c_ref = JR.rglru_apply(jc, jpj, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    y, tcache2 = TR.rglru_apply(tc, tp, torch.from_numpy(x), tcache)
    assert tcache2 is tcache                      # updated in place
    _close(y, y_ref)
    for k in ("h", "conv"):
        _close(tcache[k], c_ref[k])
