"""Command-line drivers of the port, one module per driver of the JAX
package's ``scripts/`` directory, under the same names.

Each runs as ``python -m iris_tts_tpu_torch.scripts.<name>``, and each
``main(argv=None)`` takes an argument list, so a program (or a test) can
call it in-process. Every driver takes ``--device``: the CUDA device by
default, where it raises without one; ``--device cpu`` runs it on the CPU.

The checkpoints and artifacts they read and write are the port's own
format (``torch.save`` files, ``train/checkpoint.py``,
``TTSPipeline.save``), not the JAX package's Orbax directories.
"""
