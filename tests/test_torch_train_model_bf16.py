"""``Model.loss`` in bfloat16 against the reference's (Qwen3 ``reduced``
at 2 layers): the reference runs op by op under ``jax.disable_jit()``,
as the serving tests hold bf16 (under ``jit`` XLA rounds elsewhere).
Tolerances as ``test_torch_train_model.py`` states them: metrics within
2e-2, each gradient leaf within 5e-2 of its max |g|."""
from test_torch_train_model import check_loss_case


def test_loss_and_grads_match_reference_bf16():
    check_loss_case("qwen3_1_7b", "bfloat16", num_layers=2)
