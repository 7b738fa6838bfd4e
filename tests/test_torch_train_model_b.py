"""``Model.loss`` against the reference's for the other four archs
(tolerances and method as ``test_torch_train_model.py`` states them),
and remat: with ``cfg.remat`` each group of the stack (and of Whisper's
encoder) runs under ``torch.utils.checkpoint``, and the loss and every
gradient equal those of the run without it, bitwise on the CPU, through
``Model.loss`` and through ``make_train_step``'s ``functional_call``
(whose backward pass recomputes the groups with the tensors it was
given)."""
import pytest
import torch

from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.models import stack as STACK
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import init_opt_state, make_train_step

from test_torch_train_model import check_loss_case


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_tiny",
                                  "llama_3_2_vision_11b", "xlstm_125m"])
def test_loss_and_grads_match_reference(arch):
    check_loss_case(arch)


def _batch(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=g, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.encoder_seq_len, cfg.d_model),
                                      generator=g)
    return batch


#: (arch, layers): RecurrentGemma at 5 layers is one group of ("rec",
#: "rec", "attn") and a tail of two, which runs without remat
REMAT = [("qwen3_1_7b", 3), ("recurrentgemma_2b", 5), ("whisper_tiny", 2)]


@pytest.mark.parametrize("arch,layers", REMAT)
def test_remat_equals_no_remat_bitwise(arch, layers, monkeypatch):
    groups = []
    real = STACK.checkpoint

    def counting(fn, *a, **kw):
        groups.append(a[1:])
        return real(fn, *a, **kw)
    monkeypatch.setattr(STACK, "checkpoint", counting)
    out = {}
    for remat in (False, True):
        cfg = get_config(arch).reduced(num_layers=layers, dtype="float32",
                                       remat=remat)
        m = build_model(cfg, "cpu")
        m.init_params(torch.Generator().manual_seed(0))
        m.requires_grad_(True)
        total, _ = m.loss(_batch(cfg))
        total.backward()
        out[remat] = (total.detach(),
                      {k: p.grad for k, p in m.named_parameters()})
    model = build_model(cfg, "cpu")
    want = model.stack.n_groups + (model.enc_stack.n_groups
                                   if model.enc_stack else 0)
    assert len(groups) == want > 0
    torch.testing.assert_close(out[True][0], out[False][0], atol=0, rtol=0)
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, atol=0, rtol=0,
                                   msg=k)


def test_remat_train_step_equals_no_remat_bitwise():
    """Two ``make_train_step`` steps with microbatches 2: parameters,
    moments and metrics equal with and without remat."""
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    runs = []
    for remat in (False, True):
        cfg = get_config("qwen3_1_7b").reduced(num_layers=2, dtype="float32",
                                               remat=remat)
        m = build_model(cfg, "cpu")
        params = {k: v.detach() for k, v in m.init_params(
            torch.Generator().manual_seed(1)).items()}
        opt = init_opt_state(params, ocfg)
        step = make_train_step(m, ocfg, microbatches=2)
        for i in range(2):
            params, opt, met = step(params, opt, _batch(cfg, seed=i))
        runs.append((params, opt, met))
        assert not any(p.requires_grad for p in m.parameters())
    (p0, o0, m0), (p1, o1, m1) = runs
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], atol=0, rtol=0, msg=k)
        torch.testing.assert_close(o1["m"][k], o0["m"][k], atol=0, rtol=0)
        torch.testing.assert_close(o1["v"][k], o0["v"][k], atol=0, rtol=0)
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], atol=0, rtol=0, msg=k)
