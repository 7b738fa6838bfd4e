"""The lower-precision controls, which the comparisons must fail.

Simulator cells: the plain event or wavefront simulation with its timing
state in bfloat16 in place of the program (float32). Serving cells: the plain
Qwen3 forward with its weights in float8 e4m3 (a scale per output
column) in place of the program (bfloat16), its greedy token at each
position of the same prompts read under the float32 reference.

The CPU tests run the controls at a size a test run holds. The ``cuda``
tests run them at the cells' own sizes on three seeds and print the
readings the limits were set from (``pytest -m cuda -s``).
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from perfbench.drivers import sim_sweep as SIM
from perfbench.harness import spec as S
from perfbench.reference import event_sim as ES
from perfbench.reference import qwen3 as Q
from perfbench.reference import traffic as T
from perfbench.reference import wavefront_sim as WS
from perfbench.reference.tracegen import generate

SIM_CELL = "paper-gpu.fig7-event"
SIM_CELLS = ("paper-gpu.fig7-event", "paper-gpu.hammer16k-wave")
SERVE_CELL = "qwen3-1.7b.serve-longprompt"
CONTROL_SEEDS = (2147483701, 2147483743, 3000000019)


def sim_control(cell: dict, config: dict, seed: int, device="cpu") -> dict:
    """The control's worst readings over the sims the cell samples (as
    its runs do, from sweep 0's trace seed): the bfloat16 simulation
    judged against the float32 reference, on the cell's engine."""
    ex = cell["experiment"]
    pols = config[ex["policies"]]
    rng = np.random.default_rng(seed)
    sample = ES.sample_sims(rng, 1, ex["scenarios"],
                            [p["name"] for p in pols],
                            cell["check"]["per_policy"])
    worst = {"ipc_rel": 0.0, "state_rel": 0.0, "counters_off": 0}
    for _, name, pol in sample:
        tr = generate(SIM.trace_spec(config, ex["table"], name),
                          SIM.trace_seed(seed, 0))
        p = pols[[q["name"] for q in pols].index(pol)]
        args = (tr["lines"], tr["pcs"], tr["compute_gap"],
                tr["oracle_wtype"], p, config["sim_params"])
        if ex["engine"] == "wavefront":
            wave = (ex["with"]["wave_size"], device)
            c = ES.compare(WS.simulate(*args, *wave, ft=torch.bfloat16),
                           WS.simulate(*args, *wave))
        else:
            c = ES.compare(ES.simulate(*args, rnd=ES.round_bf16),
                           ES.simulate(*args))
        worst = {k: max(worst[k], c[k]) if k != "counters_off"
                 else worst[k] + c[k] for k in worst}
    return worst


def serve_control(cell: dict, cj: dict, seed: int, device) -> dict:
    """The control's worst readings on a sample of the cell's requests
    drawn as its runs draw theirs (the longest of the first 64, then
    others until the cell's token count): the fp8 forward's greedy token
    at every served position judged against the float32 reference, and
    its prefill logits' largest error over the reference's RMS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reqs = T.generate(cell["mix"], seed)[:64]
    rng = np.random.default_rng(seed)
    longest = max(reqs, key=lambda r: (r.prompt_len + r.shared_prefix_len
                                       + r.decode_len, -r.rid))
    sample = [longest]
    for k in rng.permutation(len(reqs)):
        chk = cell["check"]
        if sum(r.decode_len for r in sample) >= chk["min_tokens"] and \
                len(sample) >= chk["min_requests"]:
            break
        if reqs[k] is not longest:
            sample.append(reqs[k])
    w = {k: v.float() for k, v in Q.make_weights(cj, seed, device).items()}
    gap = err = 0.0
    with torch.no_grad():
        for r in sample:
            toks = T.prompt_tokens(r, cj["vocab_size"])
            n = len(toks)
            seq = torch.from_numpy(np.concatenate(
                [toks, np.zeros(r.decode_len, np.int64)])).to(device)
            pos = list(range(n - 1, n + r.decode_len))
            ref = Q.forward_logits(cj, w, seq, pos)
            low = Q.forward_logits(cj, w, seq, pos, fp8=True)
            gap = max(gap, max(Q.served_gaps(ref, low.argmax(-1))))
            err = max(err, float((low[0] - ref[0]).abs().max()
                                 / ref[0].pow(2).mean().sqrt()))
    return {"token_gap": gap, "prefill_logit_err": err}


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in readings)


# ---------------------------------------------------------------------------
# at a size a test run holds
# ---------------------------------------------------------------------------

def _cut_sim(name):
    bench = S.load_benchmark()
    cell = copy.deepcopy(S.load_cell(name))
    config = copy.deepcopy(S.load_config(bench, "paper-gpu"))
    for w in (*config["workloads"].values(), *config["stress"].values()):
        w.update(n_warps=32, n_instr=4, lines_per_instr=8)
    if name == SIM_CELL:
        cell["experiment"]["scenarios"] = ["BFS", "BP", "CONS", "SRAD"]
    else:
        cell["experiment"]["with"]["wave_size"] = 8
    return cell, config


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("name", SIM_CELLS)
def test_sim_control_fails_the_limits(name, seed):
    cell, config = _cut_sim(name)
    assert _fails(sim_control(cell, config, seed), cell["check"]["limits"])


def tiny_qwen3(config: dict) -> dict:
    cj = copy.deepcopy(config)
    cj.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=128,
              vocab_size=512)
    return cj


def test_serve_control_reads_above_bf16():
    """At a tiny width the fp8 control lies further from the float32
    reference than the same weights in bfloat16 do."""
    bench = S.load_benchmark()
    cell = copy.deepcopy(S.load_cell(SERVE_CELL))
    cj = tiny_qwen3(S.load_config(bench, "qwen3-1.7b"))
    cell["mix"].update(rag_prompt=[40, 80], decode=[4, 8])
    cell["check"].update(min_tokens=16, min_requests=2)
    low = serve_control(cell, cj, 7, torch.device("cpu"))
    w = Q.make_weights(cj, 7, "cpu")
    w32 = {k: v.float() for k, v in w.items()}
    bf = {k: v.to(torch.bfloat16).float() if v.ndim > 1 else v.float()
          for k, v in w.items()}
    seq = torch.randint(1, 512, (48,), generator=torch.Generator().manual_seed(0))
    ref = Q.forward_logits(cj, w32, seq, [47])
    got = Q.forward_logits(cj, bf, seq, [47])
    bf_err = float((got - ref).abs().max() / ref.pow(2).mean().sqrt())
    assert low["prefill_logit_err"] > 2 * bf_err


# ---------------------------------------------------------------------------
# at the cells' own sizes, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("name", SIM_CELLS)
def test_sim_control_at_cell_size(cuda, name, seed):
    bench = S.load_benchmark()
    cell = S.load_cell(name)
    got = sim_control(cell, S.load_config(bench, "paper-gpu"), seed, cuda)
    print(f"control {name} seed {seed}: {got}")
    assert _fails(got, cell["check"]["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_serve_control_at_cell_size(cuda, seed):
    bench = S.load_benchmark()
    cell = S.load_cell(SERVE_CELL)
    got = serve_control(cell, S.load_config(bench, "qwen3-1.7b"), seed, cuda)
    print(f"control {SERVE_CELL} seed {seed}: {got}")
    assert _fails(got, cell["check"]["limits"])
