"""Loop reference generator — the legacy triple-nested shape, kept as the
exact-parity oracle for the vectorized sampler (copied from
``repro.core.tracegen.ref``; host-side numpy, like the sampler).

Walks warps → instructions → lanes exactly like the original
``workloads.generate`` did, but draws every random value from the
counter RNG at the cell's own (tag, index) coordinate, so it must agree
with ``sampler.generate`` bit-for-bit (tests/test_torch_tracegen_ref.py
holds it against the sampler and against the reference's loop on cut
workloads at 3 seeds). Scalar Python-int RNG mirrors (``rng.*_scalar``)
keep the loop tolerably fast.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import warp_types as WT
from repro_torch.core.tracegen import rng
from repro_torch.core.tracegen.spec import (TraceSpec, compile_schedule,
                                            lowered_gap, make_layout,
                                            phase_of_instr, trace_key)


def generate_ref(spec: TraceSpec, seed: int = 0) -> Dict[str, np.ndarray]:
    """Same output contract as ``sampler.generate``."""
    layout = make_layout(spec)
    tab = spec.archetype_table()
    n_arch = tab.shape[0]
    max_ws = max(int(tab[:, 0].max()), 1)
    i_n, w_n, l_n = spec.n_instr, spec.n_warps, spec.lines_per_instr
    _, plans = compile_schedule(spec)
    phase_of = phase_of_instr(spec)
    n_ph = len(plans)

    root = trace_key(spec.name, seed)
    k_arch = rng.stream_key_scalar(root, rng.TAG_ARCH)
    k_phase = rng.stream_key_scalar(root, rng.TAG_PHASE)
    k_pick = rng.stream_key_scalar(root, rng.TAG_PHASE_PICK)
    k_pmix = rng.stream_key_scalar(root, rng.TAG_PHASE_MIX)
    k_ws = rng.stream_key_scalar(root, rng.TAG_WS)
    k_churn = rng.stream_key_scalar(root, rng.TAG_WS_CHURN)
    k_wskey = rng.stream_key_scalar(root, rng.TAG_WS_KEY)
    k_pc = rng.stream_key_scalar(root, rng.TAG_PC)
    k_pool = rng.stream_key_scalar(root, rng.TAG_POOL)
    k_reuse = rng.stream_key_scalar(root, rng.TAG_REUSE_U)
    k_shared_u = rng.stream_key_scalar(root, rng.TAG_SHARED_U)
    k_shared_idx = rng.stream_key_scalar(root, rng.TAG_SHARED_IDX)
    k_ws_idx = rng.stream_key_scalar(root, rng.TAG_WS_IDX)

    pool = [rng.randint_scalar(k_pool, p, layout.pool_region)
            for p in range(spec.shared_pool_lines)]

    lines = np.full((i_n, w_n, l_n), -1, np.int32)
    pcs = np.zeros((i_n, w_n), np.int32)
    arch_phases = np.zeros((w_n, n_ph), np.int32)
    oracle = np.zeros((i_n, w_n), np.int32)

    def inv_cdf(cum, u):
        return min(int(np.searchsorted(cum, u, side="right")), n_arch - 1)

    for wi in range(w_n):
        # per-phase archetype / working-set-key chains, scalar mirror of
        # spec.lower (counter RNG: draw order is irrelevant, only the
        # (tag, index) coordinates must match)
        archs = [inv_cdf(plans[0].cum, rng.uniform_scalar(k_arch, wi))]
        wkeys = [rng.bits_scalar(k_ws, wi)]
        for p, plan in enumerate(plans[1:], start=1):
            if plan.legacy:
                flip = rng.uniform_scalar(k_phase, wi) < plan.flip_prob
                a = rng.randint_scalar(k_pick, wi, n_arch) if flip \
                    else archs[-1]
                archs.append(a)
                wkeys.append(wkeys[-1])
                continue
            pidx = p * w_n + wi
            flip = rng.uniform_scalar(k_phase, pidx) < plan.flip_prob
            a = inv_cdf(plan.cum, rng.uniform_scalar(k_pmix, pidx)) \
                if flip else archs[-1]
            archs.append(a)
            rekey = rng.uniform_scalar(k_churn, pidx) < plan.churn
            wkeys.append(rng.bits_scalar(k_wskey, pidx) if rekey
                         else wkeys[-1])
        arch_phases[wi] = archs

        ws_base = int(layout.ws_base(wi))
        ws_by_key = {}
        for key in wkeys:
            if key not in ws_by_key:
                ws_by_key[key] = [ws_base + rng.perm12_scalar(j, key)
                                  for j in range(max_ws)]
        pcs_w = [rng.randint_scalar(k_pc, wi * spec.n_pcs + j, 1 << 16)
                 for j in range(spec.n_pcs)]
        params = [(int(tab[a, 0]), float(tab[a, 1]), float(tab[a, 2]))
                  for a in archs]
        oracle_w = [int(WT.oracle_type_np(tab[a, 1], tab[a, 0]))
                    for a in archs]

        for ii in range(i_n):
            p = int(phase_of[ii])
            ws_size, reuse, shared = params[p]
            ws = ws_by_key[wkeys[p]]
            pcs[ii, wi] = pcs_w[ii % spec.n_pcs]
            oracle[ii, wi] = oracle_w[p]
            for li in range(l_n):
                flat = (ii * w_n + wi) * l_n + li
                u = rng.uniform_scalar(k_reuse, flat)
                u2 = rng.uniform_scalar(k_shared_u, flat)
                if ws_size and u < reuse:
                    if shared and u2 < shared:
                        lines[ii, wi, li] = pool[rng.randint_scalar(
                            k_shared_idx, flat, spec.shared_pool_lines)]
                    else:
                        lines[ii, wi, li] = ws[rng.randint_scalar(
                            k_ws_idx, flat, max(ws_size, 1))]
                else:
                    lines[ii, wi, li] = layout.fresh_addr(wi, ii * l_n + li)

    return {
        "lines": lines,
        "pcs": pcs,
        "compute_gap": lowered_gap(spec),
        "archetype": arch_phases[:, 0].copy(),
        "archetype2": arch_phases[:, -1].copy(),
        "oracle_wtype": oracle,
        "archetype_phases": arch_phases,
    }
