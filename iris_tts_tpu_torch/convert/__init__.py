"""Weight converters into the port."""

from iris_tts_tpu_torch.convert.from_jax import (
    load_train_state_from_jax,
    module_state_from_jax,
    state_dict_from_jax,
)

__all__ = [
    "load_train_state_from_jax",
    "module_state_from_jax",
    "state_dict_from_jax",
]
