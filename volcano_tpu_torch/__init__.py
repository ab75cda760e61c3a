"""PyTorch + CUDA port of the volcano_tpu batch scheduler.

A package of its own beside ``volcano_tpu``: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``volcano_tpu``.  Module names mirror the JAX
package so each module's counterpart is easy to find.  Slice 1 covers the
path from a ``ClusterStore`` to an assignment: ``synth.synthetic_cluster`` ->
``synth.solve_args_from_store`` -> ``ops.wave.solve_wave``, whose device work
runs in the hand-written CUDA kernels of ``ops/kernels.py``.
"""

__version__ = "0.1.0"
