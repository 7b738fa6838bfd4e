"""The cache pass of one wave: the port's plain version against the JAX
reference's ``wave_cache_pass(backend="ref")``, bitwise on the state, the
wave's classifier rows and all nine records. (The CUDA kernel against
the plain version: tests/test_torch_kernels_cuda.py.)

The grids are tests/test_kernels.py's adversarial same-set aliasing
grids: sets=1 collapses every request into one set (maximal conflict
chains), sets=2 makes every conflict a neighbour of the adjacent set's
chain, B >= 128 is a wide wave, and the last grid is the sparse regime
(aliasing only through the hash). The warmed state keeps the engine
invariant that non-(-1) tags are unique within a set.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JBL
from repro.core.engine.state import SimParams as JSimParams, init_state
from repro.kernels.cache_pass.ops import wave_cache_pass as j_wave_cache_pass
from repro.policy import ops as JPOL, to_arrays as j_to_arrays

from repro_torch.core import baselines as BL
from repro_torch.core.classifier import ClassifierState
from repro_torch.core.engine.state import (SimParams, SimState,
                                           state_from_numpy)
from repro_torch.kernels.cache_pass import ops as OPS
from repro_torch.policy import to_arrays

GRIDS = [(1, 8, 16, 40), (2, 8, 16, 40), (4, 12, 5, 30), (8, 160, 16, 60),
         (512, 200, 16, 4000)]
POLICIES = [(BL.BASELINE, JBL.BASELINE), (BL.MEDIC, JBL.MEDIC),
            (BL.PCAL, JBL.PCAL), (BL.WBYP, JBL.WBYP)]
RECORDS = ("t_arr", "addr", "valid", "byp", "use_l2", "hit", "hp",
           "victim_type", "ev_valid")


def cache_case(rng, n_warps, b, lanes, jprm, jpa, addr_hi=60, empty=False):
    """One fuzzed wave over a warmed reference state: (JAX state, the
    wave's per-slot arrays as numpy)."""
    sets, ways = jprm.sets, jprm.ways
    pool = np.argsort(rng.random((sets, 4 * ways + addr_hi)),
                      axis=1)[:, :ways]
    st = init_state(n_warps, jprm)
    st = st._replace(
        tags=jnp.asarray(np.where(rng.random((sets, ways)) < 0.25, -1, pool),
                         jnp.int32),
        rrip=jnp.asarray(rng.integers(0, jprm.rrip_max + 1, (sets, ways)),
                         jnp.int32),
        meta_type=jnp.asarray(rng.integers(0, 3, (sets, ways)), jnp.int32),
        eaf=jnp.asarray(rng.integers(0, 2, jprm.eaf_bits), jnp.int32),
        eaf_ctr=jnp.asarray(rng.integers(0, jprm.eaf_capacity), jnp.int32),
        pc_hits=jnp.asarray(rng.integers(0, 50, jprm.pc_entries), jnp.int32),
        pc_acc=jnp.asarray(rng.integers(50, 100, jprm.pc_entries),
                           jnp.int32),
        pc_req=jnp.asarray(rng.integers(0, 100, jprm.pc_entries), jnp.int32))
    st = st._replace(clf=st.clf._replace(
        accesses=jnp.asarray(rng.integers(0, 64, n_warps), jnp.int32),
        hits=jnp.asarray(rng.integers(0, 32, n_warps), jnp.int32),
        sampled=jnp.asarray(rng.integers(0, 64, n_warps), jnp.int32)))
    w_sel = rng.choice(n_warps, b, replace=False)
    wave = dict(
        clf_b0={f: np.asarray(v)[w_sel] for f, v in st.clf._asdict().items()},
        tokens_b=np.asarray(JPOL.pcal_tokens(jpa, n_warps))[w_sel],
        t0=np.sort(rng.uniform(0, 50, b)).astype(np.float32),
        addr_lb=rng.integers(-1, addr_hi, (lanes, b)).astype(np.int32),
        pc_b=rng.integers(0, 64, b).astype(np.int32),
        owt_b=rng.integers(0, 3, b).astype(np.int32),
        slot_ok=np.zeros(b, bool) if empty else rng.random(b) < 0.9)
    if empty:
        wave["addr_lb"][:] = -1
    return st, wave


_ARGS = ("tokens_b", "t0", "addr_lb", "pc_b", "owt_b", "slot_ok")


@partial(jax.jit, static_argnames=("prm",))
def _jax_ref(st, clf_b0, tokens_b, t0, addr_lb, pc_b, owt_b, slot_ok, pa,
             prm):
    return j_wave_cache_pass(st, clf_b0, tokens_b, t0, addr_lb, pc_b, owt_b,
                             slot_ok, prm, pa, backend="ref")


def run_jax(jst, wave, jprm, jpa):
    clf = type(jst.clf)(**{f: jnp.asarray(v)
                           for f, v in wave["clf_b0"].items()})
    return _jax_ref(jst, clf, *[jnp.asarray(wave[k]) for k in _ARGS], jpa,
                    prm=jprm)


def _state_fields(jst):
    d = {f: np.asarray(v) for f, v in jst._asdict().items()
         if f not in ("clf", "metrics")}
    d["clf"] = {f: np.asarray(v) for f, v in jst.clf._asdict().items()}
    d["metrics"] = {k: np.asarray(v) for k, v in jst.metrics.items()}
    return d


def run_torch(jst, wave, prm, pa, backend="ref", device="cpu"):
    st = state_from_numpy(_state_fields(jst), device)
    clf = ClassifierState(**{f: torch.tensor(v, device=device)
                             for f, v in wave["clf_b0"].items()})
    return OPS.wave_cache_pass(
        st, clf, *[torch.tensor(wave[k], device=device) for k in _ARGS],
        prm, pa, backend=backend)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(a, b):
    """(state, clf_b, records), every field, bitwise and same dtype."""
    (sa, ca, ra), (sb, cb, rb) = a, b
    for f in SimState._fields:
        if f == "clf":
            continue
        if f == "metrics":
            for k in getattr(sa, f):
                np.testing.assert_array_equal(_np(sa.metrics[k]),
                                              _np(sb.metrics[k]), err_msg=k)
            continue
        x, y = _np(getattr(sa, f)), _np(getattr(sb, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f"state.{f}")
    for f in ClassifierState._fields:
        x, y = _np(getattr(ca, f)), _np(getattr(cb, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f"clf_b.{f}")
    for name, x, y in zip(RECORDS, ra, rb):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=f"record {name}")


@pytest.mark.parametrize("pi", range(len(POLICIES)))
@pytest.mark.parametrize("sets,b,lanes,addr_hi", GRIDS)
def test_ref_matches_jax_aliasing_grids(sets, b, lanes, addr_hi, pi):
    pol, jpol = POLICIES[pi]
    jprm, prm = JSimParams(sets=sets), SimParams(sets=sets)
    jpa, pa = j_to_arrays(jpol), to_arrays(pol)
    rng = np.random.default_rng(sets * 1000 + b + 17 * pi)
    jst, wave = cache_case(rng, max(2 * b, b + 1), b, lanes, jprm, jpa,
                           addr_hi=addr_hi)
    assert_same(run_jax(jst, wave, jprm, jpa), run_torch(jst, wave, prm, pa))


def test_ref_empty_wave_is_a_noop():
    jprm, prm = JSimParams(sets=8), SimParams(sets=8)
    jpa, pa = j_to_arrays(JBL.MEDIC), to_arrays(BL.MEDIC)
    jst, wave = cache_case(np.random.default_rng(5), 16, 6, 8, jprm, jpa,
                           empty=True)
    out = run_torch(jst, wave, prm, pa)
    assert_same(run_jax(jst, wave, jprm, jpa), out)
    for f in ("tags", "rrip", "eaf", "pc_req"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      _np(getattr(out[0], f)), err_msg=f)


def test_ref_small_hierarchy_with_eaf_resets():
    """A tiny EAF (8-insertion reset period) and PC table: generation
    bumps happen mid-wave."""
    kw = dict(sets=8, ways=2, eaf_bits=32, eaf_capacity=8, pc_entries=8)
    jprm, prm = JSimParams(**kw), SimParams(**kw)
    for pol, jpol in POLICIES:
        jpa, pa = j_to_arrays(jpol), to_arrays(pol)
        jst, wave = cache_case(np.random.default_rng(9), 12, 6, 12, jprm,
                               jpa, addr_hi=40)
        assert_same(run_jax(jst, wave, jprm, jpa),
                    run_torch(jst, wave, prm, pa))


def test_backend_gate():
    jprm, prm = JSimParams(sets=8), SimParams(sets=8)
    jst, wave = cache_case(np.random.default_rng(2), 16, 4, 2, jprm,
                           j_to_arrays(JBL.BASELINE))
    pa = to_arrays(BL.BASELINE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_torch(jst, wave, prm, pa, backend="cuda")
    with pytest.raises(ValueError, match="unknown cache backend"):
        run_torch(jst, wave, prm, pa, backend="fused")
