"""exemplar_vae_tpu_torch: the PyTorch/CUDA port of exemplar_vae_tpu.

It mirrors the JAX package's layout (config, data/, ops/, models/, train/,
serve.py) and imports nothing of it. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; without a
card they raise. The exemplar prior's pairwise log-sum-exp runs in a CUDA
kernel written for Hopper (csrc/pairwise_lse.cu, ops/pairwise_lse.py).
"""
