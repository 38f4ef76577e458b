"""Experiment configuration: the port's own copy of the JAX package's
``Config`` (exemplar_vae_tpu/config.py). Same fields, defaults and checks,
so the ``config`` object of a JAX-exported serving bundle loads as is, and
the same experiment-directory names. Fields that only steer the TPU program
(donation, gather placement, epoch splits) are kept for that reason and
ignored by the port.

``reference_arg_parser`` and ``config_from_args`` accept the reference's
flag names and the JAX package's extras, with the same defaults; the one
flag the port reads differently is ``--no_cuda``, which the JAX package
accepts and ignores and the port's CLI takes to run on the CPU."""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import re
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

    # fields that do not change what is trained: left out of the
    # experiment-directory digest, so that e.g. more --epochs land in the
    # same directory
    _VOLATILE_FIELDS = frozenset({
        "epochs", "early_stopping_epochs", "S", "MB", "test_batch_size",
        "mesh_shape", "mesh_axes", "compute_dtype", "use_pallas_prior",
        "prior_block_n", "exact_reencode_chunk", "exact_remat", "approx_remat",
        "donate_state", "gather_in_scan", "epoch_splits",
        "data_dir", "snapshot_dir", "checkpoint_every", "checkpoint_backend",
        "resume", "eval_only", "debug_nans", "profile_epoch",
    })

    def experiment_name(self) -> str:
        """Directory name derived from the run-identity fields (the same
        name the JAX package gives the same config)."""
        core = (
            f"{self.dataset_name}_{self.model_name}_{self.prior}"
            f"_K{self.number_components}"
            f"_wu{self.warmup}_z1{self.z1_size}_z2{self.z2_size}"
        )
        if self.prior == "exemplar_prior" and self.approximate_prior:
            core += f"_approxK{self.approximate_k}"
        ident = {k: v for k, v in dataclasses.asdict(self).items()
                 if k not in self._VOLATILE_FIELDS}
        digest = hashlib.md5(
            json.dumps(ident, sort_keys=True, default=str).encode()
        ).hexdigest()[:6]
        return f"{core}_s{self.seed}_{digest}"

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


def parse_conv_spec(spec: str):
    """A conv-stack spec string -> (kind, features, kernel, stride) tuples.
    Grammar per comma-separated layer: ``[t|c]<features>k<kernel>s<stride>``
    (``t`` a transposed conv, ``c`` or nothing a conv)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        m = re.fullmatch(r"([tc]?)(\d+)k(\d+)s(\d+)", part)
        if not m:
            raise ValueError(
                f"bad conv-spec layer {part!r} (want [t|c]<feat>k<k>s<s>)")
        out.append((m.group(1) or "c", int(m.group(2)), int(m.group(3)),
                    int(m.group(4))))
    return tuple(out)


def reference_arg_parser() -> argparse.ArgumentParser:
    """argparse parser with the reference's flag names and the JAX
    package's extras, defaults from ``Config``."""
    p = argparse.ArgumentParser(description="exemplar_vae_tpu_torch")
    d = Config()
    p.add_argument("--dataset_name", type=str, default=d.dataset_name)
    p.add_argument("--model_name", type=str, default=d.model_name)
    p.add_argument("--prior", type=str, default=d.prior,
                   choices=["standard", "vampprior", "exemplar_prior"])
    p.add_argument("--number_components", type=int, default=d.number_components)
    p.add_argument("--approximate_prior", action="store_true")
    p.add_argument("--approximate_k", type=int, default=d.approximate_k)
    p.add_argument("--approximate_support", type=str,
                   default=d.approximate_support,
                   choices=["per_row", "batch_union"])
    p.add_argument("--prior_variance", type=float, default=d.prior_variance_init)
    p.add_argument("--prior_var_min", type=float, default=d.prior_var_min,
                   help="floor for the learned prior sigma^2 (0 = off)")
    p.add_argument("--q_logvar_min", type=float, default=d.q_logvar_min,
                   help="inference-net log-var clamp floor (-6 = reference)")
    p.add_argument("--no_mask", action="store_true")
    p.add_argument("--use_training_data_init", action="store_true")
    p.add_argument("--z1_size", type=int, default=d.z1_size)
    p.add_argument("--z2_size", type=int, default=d.z2_size)
    p.add_argument("--hidden_size", type=int, default=d.hidden_size)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--optimizer", type=str, default=d.optimizer,
                   choices=["adam_norm_grad", "adam"],
                   help="adam_norm_grad is the reference optimizer; adam is "
                        "the variance-reduced harness mode")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--warmup", type=int, default=d.warmup)
    p.add_argument("--early_stopping_epochs", type=int,
                   default=d.early_stopping_epochs)
    p.add_argument("--S", type=int, default=d.S)
    p.add_argument("--MB", type=int, default=d.MB)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--training_set_size", type=int, default=d.training_set_size)
    p.add_argument("--no_cuda", action="store_true",
                   help="run on the CPU (the port runs on the CUDA card "
                        "otherwise)")
    p.add_argument("--dynamic_binarization", action="store_true", default=None)
    p.add_argument("--conv_enc_spec", type=str, default=d.conv_enc_spec)
    p.add_argument("--conv_dec_spec", type=str, default=d.conv_dec_spec)
    p.add_argument("--conv_proj_channels", type=int,
                   default=d.conv_proj_channels)
    p.add_argument("--pixelcnn_features", type=int, default=d.pixelcnn_features)
    p.add_argument("--pixelcnn_layers", type=int, default=d.pixelcnn_layers)
    p.add_argument("--mesh", type=str, default=None,
                   help="comma-separated mesh shape over ('data',)")
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype)
    p.add_argument("--no_pallas", action="store_true",
                   help="blockwise torch prior instead of the pairwise-LSE "
                        "kernel")
    p.add_argument("--data_dir", type=str, default=d.data_dir)
    p.add_argument("--snapshot_dir", type=str, default=d.snapshot_dir)
    p.add_argument("--val_set_size", type=int, default=d.val_set_size)
    p.add_argument("--test_set_size", type=int, default=d.test_set_size)
    p.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    p.add_argument("--checkpoint_backend", type=str,
                   default=d.checkpoint_backend, choices=["npz", "orbax"])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--epoch_splits", type=int, default=d.epoch_splits)
    p.add_argument("--approx_remat", action="store_true")
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--profile_epoch", type=int, default=0)
    return p


def config_from_args(ns) -> Config:
    """Translate a reference-style argparse namespace into a Config (the
    device comes from ``ns.no_cuda``, not from the Config)."""
    kw = dict(
        dataset_name=ns.dataset_name,
        model_name=ns.model_name.lower(),
        prior=ns.prior,
        number_components=ns.number_components,
        approximate_prior=ns.approximate_prior,
        approximate_k=ns.approximate_k,
        approximate_support=ns.approximate_support,
        prior_variance_init=ns.prior_variance,
        prior_var_min=ns.prior_var_min,
        q_logvar_min=ns.q_logvar_min,
        no_mask=ns.no_mask,
        use_training_data_init=ns.use_training_data_init,
        z1_size=ns.z1_size,
        z2_size=ns.z2_size,
        hidden_size=ns.hidden_size,
        conv_enc_spec=ns.conv_enc_spec,
        conv_dec_spec=ns.conv_dec_spec,
        conv_proj_channels=ns.conv_proj_channels,
        pixelcnn_features=ns.pixelcnn_features,
        pixelcnn_layers=ns.pixelcnn_layers,
        batch_size=ns.batch_size,
        test_batch_size=ns.test_batch_size,
        lr=ns.lr,
        optimizer=ns.optimizer,
        epochs=ns.epochs,
        warmup=ns.warmup,
        early_stopping_epochs=ns.early_stopping_epochs,
        S=ns.S,
        MB=ns.MB,
        seed=ns.seed,
        training_set_size=ns.training_set_size,
        val_set_size=ns.val_set_size,
        test_set_size=ns.test_set_size,
        compute_dtype=ns.compute_dtype,
        use_pallas_prior=not ns.no_pallas,
        data_dir=ns.data_dir,
        snapshot_dir=ns.snapshot_dir,
        checkpoint_every=ns.checkpoint_every,
        checkpoint_backend=ns.checkpoint_backend,
        resume=ns.resume,
        eval_only=ns.eval_only,
        approx_remat=ns.approx_remat,
        epoch_splits=ns.epoch_splits,
        debug_nans=ns.debug_nans,
        profile_epoch=ns.profile_epoch,
    )
    if ns.mesh is not None:
        kw["mesh_shape"] = tuple(int(x) for x in ns.mesh.split(","))
    if ns.dynamic_binarization is not None:
        kw["dynamic_binarization_override"] = ns.dynamic_binarization
    return Config(**kw)
