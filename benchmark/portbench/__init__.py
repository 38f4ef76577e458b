"""The benchmark of exemplar_vae_tpu_torch (the PyTorch and CUDA port).

``benchmark/run.py`` is the one command; ``BENCHMARK.json`` at the root of
the repo is its manifest. Everything a cell needs is found by name from the
manifest: a configuration file under ``configs/``, a traffic file under
``traffic/`` that names its kind (``portbench/kinds/<kind>.py``), one reader
per per-layer metric under ``metrics/``, and per model family a plain
reference (``portbench/reference/<family>.py``) and a FLOP counter
(``portbench/flops/<family>.py``). Nothing here imports JAX or the JAX
package; the reference imports nothing of the port either.
"""
