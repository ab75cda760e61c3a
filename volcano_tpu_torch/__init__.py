"""PyTorch + CUDA port of the volcano_tpu batch scheduler.

A package of its own beside ``volcano_tpu``: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``volcano_tpu``.  Module names mirror the JAX
package so each module's counterpart is easy to find.  Its entry point is
the scheduler's fast-path cycle, ``scheduler.Scheduler(store).run_once()``
(``fastpath.py``), whose device work -- the two-phase wave solve
(``ops/wave.py``), the device-resident node snapshot (``ops/devsnap.py``)
and the device-incremental shortlists (``ops/devincr.py``) -- runs in the
hand-written CUDA kernels of ``ops/kernels.py``.
"""

__version__ = "0.2.0"
