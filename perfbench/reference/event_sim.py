"""Plain event-driven simulation of one (trace, policy) pair, the
benchmark's reference for the simulator's cells.

A scalar Python walk of the MeDiC memory hierarchy, written from the
semantics the program's event engine states (earliest-ready warp first,
ties to the lowest warp; each memory instruction's lanes serviced one
request at a time, in order): L2 bank queue, tag lookup with RRIP
insertion and first-maximal victim, evicted-address filter with a
generation-stamped reset, two-queue FR-FCFS DRAM with a row buffer per
channel, the per-warp classifier with its sampling windows and probes,
and the PC table. It shares no code with the program.

Every float operation of the timing model is rounded to the working
precision ``rnd``: float32 (``round_f32``) for the reference, so its
state follows the program's bit for bit; bfloat16 (``round_bf16``) for
the lower-precision control, which must then fail the comparison.
"""
from __future__ import annotations

import math
import struct
from typing import Callable, Dict, Mapping, Sequence

import numpy as np

ALL_MISS, MOSTLY_MISS, BALANCED, MOSTLY_HIT, ALL_HIT = range(5)
NUM_TYPES = 5
QDELAY_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
PC_PROBE_INTERVAL = 16
_EPS = 1e-6
_MASK32 = 0xFFFFFFFF
_HASH_MUL = 2654435761
_HASH_SALT = 0x9E3779B9

_F = struct.Struct("f")
_I = struct.Struct("I")


def round_f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (ties to even)."""
    return _F.unpack(_F.pack(x))[0]


def round_bf16(x: float) -> float:
    """``x`` rounded to float32, then to the nearest bfloat16 (ties to
    even): what one bfloat16 operation computed in float32 stores."""
    b = _I.unpack(_F.pack(x))[0]
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return _F.unpack(_I.pack(b & _MASK32))[0]


def hash_index(x: int, salt: int, mod: int) -> int:
    """Knuth multiplicative hash of ``x`` (taken as uint32) into [0, mod)."""
    h = ((x & _MASK32) * _HASH_MUL) & _MASK32
    h = (h + ((salt * _HASH_SALT) & _MASK32)) & _MASK32
    h ^= h >> 15
    return h % mod


def classify(ratio: float, samples: int, min_samples: float,
             mostly_hit: float, mostly_miss: float) -> int:
    """Hit ratio (float32) -> warp type; fewer than ``min_samples``
    samples leave a warp balanced. Thresholds compare in float32."""
    if samples < min_samples:
        return BALANCED
    t = BALANCED
    if ratio <= round_f32(mostly_miss):
        t = MOSTLY_MISS
    if ratio <= round_f32(_EPS):
        t = ALL_MISS
    if ratio >= round_f32(mostly_hit):
        t = MOSTLY_HIT
    if ratio >= round_f32(1.0 - _EPS):
        t = ALL_HIT
    return t


def simulate(lines: np.ndarray, pcs: np.ndarray, gap, oracle: np.ndarray,
             policy: Mapping, prm: Mapping,
             rnd: Callable[[float], float] = round_f32) -> Dict[str, object]:
    """One simulation. ``lines`` i32[I, W, L] (-1: no request), ``pcs``
    and ``oracle`` i32[I, W], ``gap`` the compute gap (a number, or one
    per instruction); ``policy`` holds ``bypass``, ``insertion``,
    ``scheduler``, ``rand_p``, ``pcal_frac``, ``labeling``,
    ``reclass_interval`` and ``probe_interval``; ``prm`` the hierarchy's
    sizes and latencies (the configuration's ``sim_params``). Returns the
    scalar outputs: ``ipc``, ``makespan``, ``qdelay_sum``,
    ``stall_cycles`` and the integer counters."""
    n_instr, n_warps, n_lanes = lines.shape
    lines_l, pcs_l, orc_l = lines.tolist(), pcs.tolist(), oracle.tolist()
    gaps = ([rnd(float(g)) for g in np.asarray(gap).reshape(-1)]
            if np.ndim(gap) else [rnd(float(gap))] * n_instr)
    sets, ways, banks = prm["sets"], prm["ways"], prm["banks"]
    chans, rrip_max = prm["dram_channels"], prm["rrip_max"]
    l2_svc, l2_lat = rnd(prm["l2_svc"]), rnd(prm["l2_lat"])
    occ = (rnd(prm["occ_rowmiss"]), rnd(prm["occ_rowhit"]))
    lat = (rnd(prm["t_rowmiss"]), rnd(prm["t_rowhit"]))
    eaf_bits, eaf_cap = prm["eaf_bits"], prm["eaf_capacity"]
    pc_entries, row_lines = prm["pc_entries"], prm["row_lines"]
    skew = [rnd(round_f32(k) * round_f32(prm["lane_skew"]))
            for k in range(n_lanes)]

    # the policy's knobs
    byp_mech, ins_mech = policy["bypass"], policy["insertion"]
    sched_medic = policy["scheduler"] == "medic"
    oracle_labels = policy["labeling"] == "oracle"
    interval = policy["reclass_interval"] or prm["sampling_interval"]
    max_windows = 1 if policy["labeling"] == "stale" else 1 << 30
    probe_iv = policy["probe_interval"] or prm["probe_interval"]
    min_samples = min(max(math.floor(interval / max(probe_iv, 1)), 1), 8)
    rand_p = round_f32(policy["rand_p"])
    n_tokens = max(int(np.round(np.float32(policy["pcal_frac"])
                                * np.float32(n_warps))), 1)
    tokens = [hash_index(w, 11, 997) < (997 * n_tokens) // n_warps
              for w in range(n_warps)]
    mh, mm = prm["mostly_hit_threshold"], prm["mostly_miss_threshold"]

    # machine state
    tags = [[-1] * ways for _ in range(sets)]
    rrip = [[rrip_max] * ways for _ in range(sets)]
    meta = [[BALANCED] * ways for _ in range(sets)]
    bank_free = [0.0] * banks
    cur_row = [-1] * chans
    hp_free, lp_free = [0.0] * chans, [0.0] * chans
    c_hits, c_acc, c_smp = [0] * n_warps, [0] * n_warps, [0] * n_warps
    c_type, c_win = [BALANCED] * n_warps, [0] * n_warps
    eaf, eaf_gen, eaf_ctr = [0] * eaf_bits, 1, 0
    pc_hits, pc_acc, pc_req = ([0] * pc_entries for _ in range(3))
    cnt = dict(l2_accesses=0, l2_hits=0, dram_accesses=0, row_hits=0,
               bypasses=0)
    evictions = [0] * NUM_TYPES
    qhist = [0] * (len(QDELAY_EDGES) + 1)
    qdelay_sum = stall = 0.0
    index_of: Dict[int, tuple] = {}

    def indices(addr: int) -> tuple:
        ix = index_of.get(addr)
        if ix is None:
            row = addr // row_lines
            ix = (hash_index(addr, 1, banks), hash_index(addr, 2, sets),
                  hash_index(row, 4, chans), row,
                  hash_index(addr, 5, eaf_bits),
                  hash_index(addr, 7, 65536) / 65536.0)
            index_of[addr] = ix
        return ix

    ready = [0.0] * n_warps
    ptr = [0] * n_warps
    for _ in range(n_instr * n_warps):
        w = min((ready[v], v) for v in range(n_warps)
                if ptr[v] < n_instr)[1]
        i = ptr[w]
        t0 = ready[w]
        pidx = hash_index(pcs_l[i][w], 3, pc_entries)
        owt = orc_l[i][w]
        dmax = dmin = None
        for k, addr in enumerate(lines_l[i][w]):
            if addr < 0:
                continue
            bank, sidx, ch, row, erd, rand_u = indices(addr)
            t_arr = rnd(t0 + skew[k])
            wtype = owt if oracle_labels else c_type[w]
            # bypass decision, from state before this request
            if byp_mech == "medic":
                probe = c_acc[w] % probe_iv == probe_iv - 1
                byp = wtype <= MOSTLY_MISS and not probe
            elif byp_mech == "pcal":
                byp = not tokens[w]
            elif byp_mech == "pcbyp":
                ratio = round_f32(pc_hits[pidx] / max(pc_acc[pidx], 1))
                byp = (pc_acc[pidx] > 32 and ratio < 0.25
                       and pc_req[pidx] % PC_PROBE_INTERVAL
                       != PC_PROBE_INTERVAL - 1)
            elif byp_mech == "rand":
                byp = rand_u < rand_p
            else:
                byp = False
            use_l2 = not byp
            # L2 bank queue
            t_head = max(bank_free[bank], t_arr)
            qdelay = 0.0
            if use_l2:
                bank_free[bank] = rnd(t_head + l2_svc)
                qdelay = rnd(t_head - t_arr)
            # lookup, RRIP fill and insertion
            tset, rset = tags[sidx], rrip[sidx]
            hit = use_l2 and addr in tset
            if hit:
                rset[tset.index(addr)] = 0
            elif use_l2:
                shift = rrip_max - max(rset)
                aged = [r + shift for r in rset]
                victim = aged.index(max(aged))
                evicted, vtype = tset[victim], meta[sidx][victim]
                if ins_mech == "medic":
                    rank = (0 if wtype >= MOSTLY_HIT else
                            rrip_max - 2 if wtype == BALANCED
                            else rrip_max - 1)
                elif ins_mech == "eaf":
                    rank = 0 if eaf[erd] == eaf_gen else rrip_max - 1
                else:
                    rank = 0
                aged[victim] = rank
                rrip[sidx] = aged
                tset[victim] = addr
                meta[sidx][victim] = wtype
                if evicted >= 0:
                    evictions[vtype] += 1
                    eaf[hash_index(evicted, 5, eaf_bits)] = eaf_gen
                    eaf_ctr += 1
                    if eaf_ctr >= eaf_cap:
                        eaf_gen, eaf_ctr = eaf_gen + 1, 0
            # DRAM: two-queue FR-FCFS with a row buffer per channel
            if hit:
                done = rnd(t_head + l2_lat)
            else:
                t_dram = t_arr if byp else rnd(t_head + l2_lat)
                row_hit = cur_row[ch] == row
                hp = sched_medic and wtype >= MOSTLY_HIT
                if hp:
                    start = max(hp_free[ch], t_dram)
                    hp_free[ch] = rnd(start + occ[row_hit])
                else:
                    start = max(lp_free[ch], hp_free[ch], t_dram)
                    lp_free[ch] = rnd(start + occ[row_hit])
                cur_row[ch] = row
                done = rnd(start + lat[row_hit])
                cnt["dram_accesses"] += 1
                cnt["row_hits"] += row_hit
            # classifier window, PC table and counters
            c_hits[w] += hit
            c_acc[w] += 1
            c_smp[w] += use_l2
            if c_acc[w] >= interval:
                ratio = round_f32(c_hits[w] / max(c_smp[w], 1))
                if c_win[w] < max_windows:
                    c_type[w] = classify(ratio, c_smp[w], min_samples, mh,
                                         mm)
                c_hits[w] = c_acc[w] = c_smp[w] = 0
                c_win[w] += 1
            pc_hits[pidx] += hit
            pc_acc[pidx] += use_l2
            pc_req[pidx] += 1
            if use_l2:
                qhist[sum(qdelay >= e for e in QDELAY_EDGES)] += 1
                qdelay_sum = rnd(qdelay_sum + qdelay)
            cnt["l2_accesses"] += use_l2
            cnt["l2_hits"] += hit
            cnt["bypasses"] += byp
            dmax = done if dmax is None else max(dmax, done)
            dmin = done if dmin is None else min(dmin, done)
        if dmax is None:
            ready[w] = rnd(t0 + gaps[i])
        else:
            stall = rnd(stall + rnd(dmax - dmin))
            ready[w] = rnd(dmax + gaps[i])
        ptr[w] = i + 1

    last_gap = gaps[-1]
    ipc = sum(n_instr / max(rnd(r - last_gap), 1.0) for r in ready)
    out: Dict[str, object] = dict(cnt)
    out.update(ipc=ipc, makespan=max(ready), qdelay_sum=qdelay_sum,
               stall_cycles=stall, evictions_by_type=evictions,
               qdelay_hist=qhist)
    return out


#: the outputs compared exactly, as integers
INT_OUTPUTS = ("l2_accesses", "l2_hits", "dram_accesses", "row_hits",
               "bypasses", "evictions_by_type", "qdelay_hist")
#: the float32 state compared by relative gap (exact when the state
#: follows the program's bit for bit)
STATE_OUTPUTS = ("makespan", "qdelay_sum", "stall_cycles")


def policy_fields(policy) -> Dict[str, object]:
    """The fields of a policy preset (an object with the attributes of
    ``simulate``'s ``policy`` mapping) as a plain dict."""
    return {k: getattr(policy, k) for k in (
        "bypass", "insertion", "scheduler", "rand_p", "pcal_frac",
        "labeling", "reclass_interval", "probe_interval")}


def compare(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """Gaps of one simulation: ``ipc_rel`` (relative), ``state_rel`` (the
    largest relative gap of the float32 state outputs) and
    ``counters_off`` (integer counters that differ)."""
    ipc_p, ipc_r = float(program["ipc"]), float(reference["ipc"])
    state = max(abs(float(program[k]) - float(reference[k]))
                / max(abs(float(reference[k])), 1e-30)
                for k in STATE_OUTPUTS)
    off = 0
    for k in INT_OUTPUTS:
        a = np.asarray(program[k]).reshape(-1).astype(np.int64)
        b = np.asarray(reference[k]).reshape(-1).astype(np.int64)
        off += int(a.shape != b.shape) or int((a != b).sum())
    return {"ipc_rel": abs(ipc_p - ipc_r) / max(abs(ipc_r), 1e-30),
            "state_rel": state, "counters_off": off}


def sample_sims(rng: np.random.Generator, n_sweeps: int,
                workloads: Sequence[str], policies: Sequence[str],
                per_policy: int) -> list:
    """(sweep, workload, policy) triples drawn from the sweeps a window
    finished, ``per_policy`` distinct (sweep, workload) pairs for every
    policy: the policies are where the program's branches differ, so
    each is judged in every run."""
    pairs = n_sweeps * len(workloads)
    out = []
    for policy in policies:
        for f in rng.choice(pairs, size=min(per_policy, pairs),
                            replace=False):
            s, wi = divmod(int(f), len(workloads))
            out.append((s, workloads[wi], policy))
    return sorted(out, key=lambda t: (t[0], workloads.index(t[1]),
                                      policies.index(t[2])))
