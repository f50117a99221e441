"""Checkpoints of the port: its own files, the JAX package's, and the
reference's PyTorch format."""

from show_and_tell_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    copy_into,
    load_best_params,
    load_infos,
    load_train_state,
    load_trunk,
    save_best,
    save_infos,
    save_train_state,
    trainable_state_dict,
)
