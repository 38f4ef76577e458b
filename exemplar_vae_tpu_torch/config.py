"""Experiment configuration: the port's own copy of the JAX package's
``Config`` (exemplar_vae_tpu/config.py). Same fields, defaults and checks,
so the ``config`` object of a JAX-exported serving bundle loads as is.
Fields that only steer the TPU program (mesh, remat, epoch scans) are kept
for that reason and ignored by the port."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # --- experiment selection ---
    dataset_name: str = "dynamic_mnist"
    model_name: str = "vae"              # vae | hvae_2level | convhvae_2level
    prior: str = "exemplar_prior"        # standard | vampprior | exemplar_prior

    # --- architecture ---
    z1_size: int = 40
    z2_size: int = 40
    hidden_size: int = 300
    input_size: Tuple[int, int, int] = (1, 28, 28)   # (C, H, W)
    input_type: str = "binary"           # binary | gray | continuous
    dynamic_binarization: bool = True
    dynamic_binarization_override: "Optional[bool]" = None

    # --- prior parameters ---
    number_components: int = 50_000      # exemplar-set size N
    approximate_prior: bool = False
    approximate_k: int = 10
    approximate_support: str = "per_row"  # per_row | batch_union
    prior_variance_init: float = 1.0
    prior_var_min: float = 0.0           # opt-in floor of sigma^2 (0 = off)
    q_logvar_min: float = -6.0           # floor of the q log-var clamp
    no_mask: bool = False
    use_training_data_init: bool = False
    bank_stochastic_preprocess: bool = False

    # --- ConvHVAE / PixelHVAE architecture ---
    conv_enc_spec: str = "32k7s1,32k3s2,64k5s1,64k3s2"
    conv_dec_spec: str = "t64k3s2,t32k3s2,c32k3s1"
    conv_proj_channels: int = 64
    pixelcnn_features: int = 64
    pixelcnn_layers: int = 4

    # --- optimization ---
    optimizer: str = "adam_norm_grad"
    lr: float = 5e-4
    batch_size: int = 100
    test_batch_size: int = 100
    epochs: int = 2000
    warmup: int = 100
    early_stopping_epochs: int = 50
    seed: int = 14

    # --- evaluation ---
    S: int = 5000                        # importance samples for test NLL
    MB: int = 500                        # importance-sample chunk size

    # --- device knobs ---
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    compute_dtype: str = "float32"       # bfloat16: bf16 matmul inputs
    use_pallas_prior: bool = True        # the pairwise-LSE kernel (else scan)
    prior_block_n: int = 2048            # exemplar tile of the blockwise prior
    exact_reencode_chunk: int = 8192     # bank encode chunk
    exact_remat: bool = True
    approx_remat: bool = False
    donate_state: bool = True
    gather_in_scan: str = "auto"
    epoch_splits: int = 0

    # --- infrastructure ---
    data_dir: str = "datasets"
    snapshot_dir: str = "snapshots"
    training_set_size: int = 50_000
    val_set_size: int = 10_000
    test_set_size: int = 10_000
    checkpoint_every: int = 0
    checkpoint_backend: str = "npz"
    resume: bool = False
    eval_only: bool = False
    debug_nans: bool = False
    profile_epoch: int = 0

    def __post_init__(self):
        choices = {
            "approximate_support": ("per_row", "batch_union"),
            "prior": ("standard", "vampprior", "exemplar_prior"),
            "input_type": ("binary", "gray", "continuous"),
            "checkpoint_backend": ("npz", "orbax"),
            "compute_dtype": ("float32", "bfloat16"),
            "gather_in_scan": ("auto", "in_scan", "pregather"),
        }
        for name, allowed in choices.items():
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(f"Config.{name}={v!r}; expected one of "
                                 f"{allowed}")
        if self.val_set_size <= 0:
            raise ValueError(f"Config.val_set_size={self.val_set_size}; the "
                             f"protocol needs a validation split")
        if self.epoch_splits < 0:
            raise ValueError(f"Config.epoch_splits={self.epoch_splits}; must "
                             f"be >= 0")
        if self.prior_block_n <= 0:
            raise ValueError(f"Config.prior_block_n={self.prior_block_n}; "
                             f"must be positive")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def input_dim(self) -> int:
        c, h, w = self.input_size
        return c * h * w

    @property
    def loo_mask_enabled(self) -> bool:
        return self.prior == "exemplar_prior" and not self.no_mask

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s) -> "Config":
        """Config from a JSON string or an already-parsed dict."""
        d = json.loads(s) if isinstance(s, str) else dict(s)
        for k in ("input_size", "mesh_shape", "mesh_axes"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return Config(**d)
