"""AdamW, its schedule and the train-step factory (port of
``repro.optim``)."""
from repro_torch.optim.optimizer import (adamw_update, compressed_psum,
                                         init_opt_state, lr_schedule,
                                         make_train_step, quantize_int8)

__all__ = ["adamw_update", "compressed_psum", "init_opt_state",
           "lr_schedule", "make_train_step", "quantize_int8"]
