"""Parameter and batch placement rules.

Counterpart of the JAX package's ``parallel/sharding.py``. There, wide
trailing (output-channel) parameter dims shard over the ``model`` axis and
GSPMD infers the gathers. The port has no model axis yet (``ROADMAP.md``
§A.6b: every conv and dense layer needs a column-parallel rewrite with
explicit gathers), so on its meshes the rule is full replication, which is
what JAX's rule gives when the model axis has size 1.
"""

from __future__ import annotations

from typing import Any

from iris_tts_tpu_torch.config import MeshConfig
from iris_tts_tpu_torch.parallel.mesh import Mesh, replicate_params, shard_batch


def tp_param_sharding(params: Any, mesh: Mesh,
                      cfg: MeshConfig = MeshConfig(),
                      min_dim: int = 8) -> Any:
    """Place a module's parameters (or a tree of tensors) on ``mesh``:
    replicated from rank 0, as JAX's rule places every leaf when the model
    axis has size 1. A mesh with a model axis raises."""
    del min_dim  # the width rule applies to a model axis
    model_size = mesh.shape[cfg.model_axis]
    if model_size > 1:
        raise NotImplementedError(
            f"a model axis of {model_size}: tensor-parallel parameter "
            "sharding is not ported yet, see ROADMAP.md §A.6b")
    return replicate_params(params, mesh)


def batch_sharding_tree(batch: Any, mesh: Mesh,
                        cfg: MeshConfig = MeshConfig()):
    """Alias of :func:`iris_tts_tpu_torch.parallel.mesh.shard_batch`."""
    return shard_batch(batch, mesh, cfg)
