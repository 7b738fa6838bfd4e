"""The port's shared math against the JAX reference, bitwise.

The same numpy-seeded inputs go through ``repro`` (JAX on the CPU) and
``repro_torch`` (torch on the CPU): the uint32 hash (including the
inactive-lane address -1 and 2**31-1), the warp-type ladder, every
policy op over every preset in ``core/baselines.py``, the classifier
observe, the request index helpers, the queue-delay binning and the
``state_from_numpy`` / ``arrays_from_numpy`` round trips.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import baselines as JBL
from repro.core import classifier as JCLF
from repro.core import warp_types as JWT
from repro.core.engine import request as JREQ
from repro.core.engine import state as JSTATE
from repro.kernels.cache_pass import ref as JCREF
from repro.policy import ops as JPOL, to_arrays as j_to_arrays

from repro_torch.core import baselines as BL
from repro_torch.core import classifier as CLF
from repro_torch.core import warp_types as WT
from repro_torch.core.engine import request as REQ
from repro_torch.core.engine import state as STATE
from repro_torch.kernels.cache_pass import ref as CREF
from repro_torch.policy import (arrays_from_numpy, ops as POL,
                                to_arrays)

PRESETS = BL.ALL_NAMED + BL.RAND_SWEEP + BL.LABELING_LADDER
J_PRESETS = JBL.ALL_NAMED + JBL.RAND_SWEEP + JBL.LABELING_LADDER


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b.numpy() if torch.is_tensor(b)
                                      else b)
    assert a.dtype == b.dtype, f"{msg}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _pair(i):
    """(torch preset, JAX preset) i, checked to be the same policy."""
    p, jp = PRESETS[i], J_PRESETS[i]
    assert p.name == jp.name
    return p, jp


def test_presets_mirror_reference():
    assert [p.name for p in PRESETS] == [p.name for p in J_PRESETS]
    for p, jp in zip(PRESETS, J_PRESETS):
        pa, jpa = to_arrays(p), j_to_arrays(jp)
        for f in jpa._fields:
            _eq(getattr(jpa, f), getattr(pa, f), f"{p.name}.{f}")


@pytest.mark.parametrize("salt,mod", [(1, 6), (2, 512), (3, 256), (4, 8),
                                      (5, 4096), (7, 65536), (11, 997)])
def test_hash_index_bitwise(salt, mod):
    rng = np.random.default_rng(salt)
    x = np.concatenate([
        np.asarray([-1, 0, 1, 2**31 - 1, -2**31, -2], np.int32),
        rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32),
        rng.integers(-1, 5000, 512).astype(np.int32)])
    _eq(JPOL.hash_index(jnp.asarray(x), salt, mod),
        POL.hash_index(torch.as_tensor(x), salt, mod), f"salt {salt}")


def test_classify_ladder_bitwise():
    edges = np.asarray([0.0, 1e-6, 0.2, 0.8, 1.0 - 1e-6, 1.0], np.float32)
    near = np.concatenate([edges, np.nextafter(edges, 2.0),
                           np.nextafter(edges, -1.0)])
    r = np.concatenate([near, np.random.default_rng(0).random(2000)
                        .astype(np.float32)])
    acc = np.random.default_rng(1).integers(0, 16, r.shape[0]).astype(
        np.int32)
    for min_samples in (8, 1, np.float32(4.0)):
        ms_t = torch.tensor(min_samples) if isinstance(min_samples,
                                                       np.floating) \
            else min_samples
        _eq(JWT.classify(jnp.asarray(r), jnp.asarray(acc),
                         min_samples=jnp.asarray(min_samples)),
            WT.classify(torch.as_tensor(r), torch.as_tensor(acc),
                        min_samples=ms_t), f"min_samples {min_samples}")
    wt = np.arange(5, dtype=np.int32)
    _eq(JWT.insertion_rank(jnp.asarray(wt), 6),
        WT.insertion_rank(torch.as_tensor(wt), 6))


def _signals(rng, n=512):
    return dict(
        wtype=rng.integers(0, 5, n).astype(np.int32),
        probe=rng.random(n) < 0.3,
        token_bit=rng.random(n) < 0.5,
        pc_hits=rng.integers(0, 60, n).astype(np.int32),
        pc_acc=rng.integers(0, 120, n).astype(np.int32),
        pc_req=rng.integers(0, 200, n).astype(np.int32),
        rand_u=rng.random(n).astype(np.float32),
        eaf_bit=rng.random(n) < 0.5,
        oracle=rng.integers(0, 5, n).astype(np.int32))


@pytest.mark.parametrize("i", range(len(PRESETS)))
def test_policy_ops_bitwise_every_preset(i):
    p, jp = _pair(i)
    pa, jpa = to_arrays(p), j_to_arrays(jp)
    s = _signals(np.random.default_rng(100 + i))
    j = {k: jnp.asarray(v) for k, v in s.items()}
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    keys = ("wtype", "probe", "token_bit", "pc_hits", "pc_acc", "pc_req",
            "rand_u")
    _eq(JPOL.bypass_decision(jpa, **{k: j[k] for k in keys}),
        POL.bypass_decision(pa, **{k: t[k] for k in keys}), "bypass")
    _eq(JPOL.insertion_rank(jpa, wtype=j["wtype"], eaf_bit=j["eaf_bit"],
                            rrip_max=7),
        POL.insertion_rank(pa, wtype=t["wtype"], eaf_bit=t["eaf_bit"],
                           rrip_max=7), "insertion_rank")
    _eq(JPOL.is_high_priority(jpa, j["wtype"]),
        POL.is_high_priority(pa, t["wtype"]), "is_high_priority")
    _eq(JPOL.select_label(jpa, j["wtype"], j["oracle"]),
        POL.select_label(pa, t["wtype"], t["oracle"]), "select_label")
    _eq(JPOL.reclass_max_windows(jpa), POL.reclass_max_windows(pa))
    _eq(JPOL.reclass_interval(jpa, 64), POL.reclass_interval(pa, 64))
    _eq(JPOL.probe_interval(jpa, 8), POL.probe_interval(pa, 8))
    for w in (1, 7, 48, 256, 2048):
        _eq(JPOL.pcal_tokens(jpa, w), POL.pcal_tokens(pa, w), f"tokens {w}")


@pytest.mark.parametrize("i", range(0, len(PRESETS), 3))
def test_bypass_decision_core_bitwise(i):
    """The request-level bypass (label select + probe cadence + draw)."""
    p, jp = _pair(i)
    pa, jpa = to_arrays(p), j_to_arrays(jp)
    rng = np.random.default_rng(7 + i)
    n = 300
    args = dict(wt=rng.integers(0, 5, n), acc=rng.integers(0, 70, n),
                tok=rng.random(n) < 0.5, ph=rng.integers(0, 60, n),
                pac=rng.integers(0, 99, n), pr=rng.integers(0, 99, n),
                addr=rng.integers(-1, 10**6, n),
                valid=rng.random(n) < 0.9, owt=rng.integers(0, 5, n))
    args = {k: (v if v.dtype == bool else v.astype(np.int32))
            for k, v in args.items()}
    order = ("wt", "acc", "tok", "ph", "pac", "pr", "addr", "valid")
    jb, jw = JREQ.bypass_decision_core(
        *[jnp.asarray(args[k]) for k in order], JSTATE.SimParams(), jpa,
        jnp.asarray(args["owt"]))
    tb, tw = REQ.bypass_decision_core(
        *[torch.as_tensor(args[k]) for k in order], STATE.SimParams(), pa,
        torch.as_tensor(args["owt"]))
    _eq(jb, tb, "byp")
    _eq(jw, tw, "wtype")


@pytest.mark.parametrize("i", [0, 6, 7, 17, 18, 19, 20])
def test_observe_bitwise(i):
    """classifier.observe (warp-id scatter form, with the policy's window,
    label cap and probe-adapted floor) and the wave-resident observe_vec,
    over several windows' worth of updates."""
    p, jp = _pair(i)
    pa, jpa = to_arrays(p), j_to_arrays(jp)
    jprm, prm = JSTATE.SimParams(), STATE.SimParams()
    rng = np.random.default_rng(i)
    jst, st = JCLF.init(16), CLF.init(16)
    jb, tb = JCLF.init(16), CLF.init(16)
    interval = JPOL.reclass_interval(jpa, 64)
    for _ in range(150):       # ~2 windows of 64 accesses, 4 of 32
        wid = rng.permutation(16).astype(np.int32)
        hit = rng.random(16) < rng.random()
        weight = (rng.random(16) < 0.9).astype(np.int32)
        probed = weight * (rng.random(16) < 0.7)
        kw = dict(weight=weight, probed=probed.astype(np.int32))
        jst = JCLF.observe(
            jst, jnp.asarray(wid), jnp.asarray(hit),
            sampling_interval=interval,
            max_windows=JPOL.reclass_max_windows(jpa),
            probe_interval=JPOL.probe_interval(jpa, 8),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        st = CLF.observe(
            st, torch.as_tensor(wid), torch.as_tensor(hit),
            sampling_interval=POL.reclass_interval(pa, 64),
            max_windows=POL.reclass_max_windows(pa),
            probe_interval=POL.probe_interval(pa, 8),
            **{k: torch.as_tensor(v) for k, v in kw.items()})
        jb = JCREF.observe_vec(jb, jnp.asarray(hit), jnp.asarray(weight),
                               jnp.asarray(probed.astype(np.int32)), jprm,
                               jpa)
        tb = CREF.observe_vec(tb, torch.as_tensor(hit),
                              torch.as_tensor(weight),
                              torch.as_tensor(probed.astype(np.int32)), prm,
                              pa)
    assert int(np.asarray(jst.windows).min()) >= 1   # windows did close
    for f in JCLF.ClassifierState._fields:
        _eq(getattr(jst, f), getattr(st, f), f"observe.{f}")
        _eq(getattr(jb, f), getattr(tb, f), f"observe_vec.{f}")
    _eq(JCLF.min_probe_samples(jnp.float32(64), jnp.float32(8)),
        CLF.min_probe_samples(torch.tensor(64.0), torch.tensor(8.0)))


@pytest.mark.parametrize("min_samples", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_force_classify_bitwise(seed, min_samples):
    """classifier.force_classify on seeded mid-window states (counts of 0
    to 8 samples, so some warps sit under the floor and keep their label)
    with both threshold pairs."""
    rng = np.random.default_rng(seed)
    n = 64
    sampled = rng.integers(0, 9, n).astype(np.int32)
    fields = dict(
        hits=(sampled * rng.random(n)).round().astype(np.int32),
        accesses=(sampled + rng.integers(0, 5, n)).astype(np.int32),
        warp_type=rng.integers(0, 5, n).astype(np.int32),
        ratio=rng.random(n).astype(np.float32),
        windows=rng.integers(0, 3, n).astype(np.int32),
        sampled=sampled)
    fields["hits"][:4] = fields["sampled"][:4]      # ratio exactly 1
    fields["hits"][4:8] = 0                         # ratio exactly 0
    jst = JCLF.ClassifierState(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    st = CLF.ClassifierState(**{k: torch.from_numpy(v)
                                for k, v in fields.items()})
    for kw in (dict(), dict(mostly_hit_threshold=0.7,
                            mostly_miss_threshold=0.3)):
        jf = JCLF.force_classify(jst, min_samples=min_samples, **kw)
        tf = CLF.force_classify(st, min_samples=min_samples, **kw)
        for f in JCLF.ClassifierState._fields:
            _eq(getattr(jf, f), getattr(tf, f), f"force_classify.{f}")
        kept = sampled < min_samples
        assert kept.any() and not kept.all()
        np.testing.assert_array_equal(tf.warp_type.numpy()[kept],
                                      fields["warp_type"][kept])


def test_request_index_helpers_bitwise():
    rng = np.random.default_rng(3)
    addr = np.concatenate([np.asarray([-1, -32, -33, 0, 31, 32, 2**31 - 1],
                                      np.int32),
                           rng.integers(-1, 2**31 - 1, 4000).astype(
                               np.int32)])
    for prm_kw in ({}, dict(sets=8, banks=3, dram_channels=4, row_lines=16,
                            eaf_bits=32, pc_entries=8)):
        jprm, prm = JSTATE.SimParams(**prm_kw), STATE.SimParams(**prm_kw)
        ja, ta = jnp.asarray(addr), torch.as_tensor(addr)
        for name in ("bank_index", "set_index", "pc_index", "dram_channel",
                     "dram_row", "eaf_index"):
            _eq(getattr(JREQ, name)(ja, jprm), getattr(REQ, name)(ta, prm),
                name)
    rh = rng.random(64) < 0.5
    for jx, tx in zip(JREQ.dram_occ_lat(jnp.asarray(rh), JSTATE.SimParams()),
                      REQ.dram_occ_lat(torch.as_tensor(rh),
                                       STATE.SimParams())):
        _eq(jx, tx, "dram_occ_lat")


def test_qdelay_bin_bitwise():
    edges = np.asarray([0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024],
                       np.float32)
    q = np.concatenate([edges, np.nextafter(edges, -1), [0.0, 5e8, 2e9],
                        np.random.default_rng(4).exponential(60, 3000)]
                       ).astype(np.float32)
    _eq(JREQ.qdelay_bin(jnp.asarray(q)), REQ.qdelay_bin(torch.as_tensor(q)))
    _eq(JSTATE._QBINS, STATE._QBINS)
    assert STATE.N_QBINS == JSTATE.N_QBINS


def _state_fields(jst):
    """A reference SimState as the numpy field dict state_from_numpy
    takes."""
    d = {f: np.asarray(v) for f, v in jst._asdict().items()
         if f not in ("clf", "metrics")}
    d["clf"] = {f: np.asarray(v) for f, v in jst.clf._asdict().items()}
    d["metrics"] = {k: np.asarray(v) for k, v in jst.metrics.items()}
    return d


def test_state_from_numpy_round_trip():
    jprm = JSTATE.SimParams(sets=16)
    rng = np.random.default_rng(8)
    jst = JSTATE.init_state(12, jprm)
    jst = jst._replace(
        tags=jnp.asarray(rng.integers(-1, 99, (16, 8)), jnp.int32),
        bank_free=jnp.asarray(rng.random(6) * 100, jnp.float32),
        eaf_gen=jnp.asarray(3, jnp.int32),
        clf=jst.clf._replace(ratio=jnp.asarray(rng.random(12),
                                               jnp.float32)))
    fields = _state_fields(jst)
    st = STATE.state_from_numpy(fields, "cpu")
    _eq(jst.tags, st.tags)
    for f in STATE.SimState._fields:
        if f == "clf":
            for g in CLF.ClassifierState._fields:
                _eq(getattr(jst.clf, g), getattr(st.clf, g), f"clf.{g}")
        elif f == "metrics":
            assert set(st.metrics) == set(jst.metrics)
            for k in jst.metrics:
                _eq(jst.metrics[k], st.metrics[k], f"metrics.{k}")
        else:
            _eq(getattr(jst, f), getattr(st, f), f)
    # the port's own init_state is the reference's, field for field
    _eq_state(JSTATE.init_state(12, jprm),
              STATE.init_state(12, STATE.SimParams(sets=16)))


def _eq_state(jst, st):
    ref = _state_fields(jst)
    got = STATE.state_from_numpy(ref, "cpu")
    for f in ("tags", "rrip", "meta_type", "bank_free", "cur_row", "eaf",
              "eaf_gen", "pc_req", "tot_acc"):
        _eq(getattr(got, f), getattr(st, f), f)
    for g in CLF.ClassifierState._fields:
        _eq(getattr(got.clf, g), getattr(st.clf, g), f"clf.{g}")
    for k in ref["metrics"]:
        _eq(got.metrics[k], st.metrics[k], k)


def test_arrays_from_numpy_round_trip():
    for p, jp in zip(PRESETS, J_PRESETS):
        jpa = j_to_arrays(jp)
        pa = arrays_from_numpy({f: np.asarray(v) for f, v in
                                jpa._asdict().items()}, "cpu")
        for f in jpa._fields:
            _eq(getattr(jpa, f), getattr(pa, f), f"{p.name}.{f}")


@pytest.mark.parametrize("per_instr_gap", [False, True])
def test_finalize_outputs(per_instr_gap):
    """Per-element outputs bitwise; the closing float sums (ipc, energy,
    ...) differ only in summation order (rtol 1e-6)."""
    rng = np.random.default_rng(11 + per_instr_gap)
    w, i = 40, 12
    jprm = JSTATE.SimParams()
    jst = JSTATE.init_state(w, jprm)
    metrics = {k: jnp.asarray(rng.integers(0, 5000, np.shape(v)), v.dtype)
               if v.dtype == jnp.int32 else
               jnp.asarray(rng.random(np.shape(v)) * 1e4, v.dtype)
               for k, v in jst.metrics.items()}
    jst = jst._replace(
        metrics=metrics,
        tot_hits=jnp.asarray(rng.integers(0, 50, w), jnp.int32),
        tot_acc=jnp.asarray(rng.integers(0, 90, w), jnp.int32),
        clf=jst.clf._replace(warp_type=jnp.asarray(rng.integers(0, 5, w),
                                                   jnp.int32)))
    ready = (rng.random(w) * 9000).astype(np.float32)
    ratio_t = rng.random((i, w)).astype(np.float32)
    gap = (rng.random(i) * 100).astype(np.float32) if per_instr_gap \
        else np.float32(16.0)
    ref = JREQ.finalize_outputs(jst, jnp.asarray(ready), jnp.asarray(ratio_t),
                                jnp.asarray(gap), n_instr=i, n_warps=w,
                                prm=jprm)
    got = REQ.finalize_outputs(
        STATE.state_from_numpy(_state_fields(jst), "cpu"),
        torch.tensor(ready), torch.tensor(ratio_t), torch.tensor(gap),
        n_instr=i, n_warps=w, prm=STATE.SimParams())
    assert set(got) == set(ref)
    for k in ref:
        if k in ("ipc", "energy", "perf_per_energy"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=0, err_msg=k)
        else:
            _eq(ref[k], got[k], k)
