"""Config system: accepts the reference's flat JSON schema verbatim.

The port's own copy of ``multimodalbrainsurvival_tpu/config.py`` (stdlib
only): the same known keys, and the typed accessors the ported paths read,
with the same defaults.

Keys of the JAX package that mean nothing here (XLA buffer donation,
checkify, the JAX profiler, multi-host preemption consensus) are reported
as ignored, as ``use_cuda`` is (the device comes from ``--device``), and so
is ``emergency_checkpoint``: the port has no SIGTERM save yet (ROADMAP.md,
item 10), so a run keeps only its epoch-boundary ``train_state.pt``. Keys
that change results but whose path is not ported yet raise, with a pointer
to ROADMAP.md, rather than being dropped silently.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

KNOWN_KEYS = {
    # model
    "model_name", "num_classes", "pretrained", "pretrained_path",
    "aggregator", "aggregator_hdim", "transformer_layers",
    "n_layers_to_train", "task", "target_label",
    # data
    "data_path", "train_csv_path", "val_csv_path", "test_csv_path",
    "img_size", "train_bag_size", "val_bag_size",
    "max_patch_per_wsi_train", "max_patch_per_wsi_val",
    "num_workers", "weighted_sampler", "quick",
    # optimization
    "batch_size", "num_epochs", "lr", "lr_rna", "lr_mlp", "lr_histo",
    "weight_decay", "use_cuda",
    # paths / experiment
    "flag", "checkpoint_path", "summary_path", "output_path",
    "model_path", "restore_path", "histo_restore_path", "rna_restore_path",
    # extensions of the JAX package (not in reference)
    "compute_dtype", "reference_parity", "mesh", "log_interval",
    "keep_bag_remainder", "num_devices", "resume", "fold_bn",
    "cache_patches_on_device", "cache_max_bytes_per_device",
    "emergency_checkpoint", "preempt_sync_every", "compile_cache_dir",
    "dropout", "augment",
    "quantize", "quantize_trunk", "remat", "freeze_bn", "accumulate_steps",
    "lr_schedule", "warmup_steps", "lr_min_factor", "lr_step_every_epochs",
    "lr_step_gamma", "grad_clip_norm", "early_stop_patience",
    "early_stop_min_delta",
    "export_path", "export_kind",
    "profile_steps", "profile_dir", "debug_checkify", "donate_state",
    "slide_csv_path", "slide_path", "slides", "max_patches_per_slide",
    "dezoom_factor", "background_threshold", "save_patch_features",
    "cv_csv_path", "cv_folds",
}


#: read by the JAX package only; no meaning (or, for emergency_checkpoint,
#: no implementation yet) in the port
IGNORED_KEYS = ("use_cuda", "donate_state", "debug_checkify", "profile_steps",
                "profile_dir", "preempt_sync_every", "compile_cache_dir",
                "emergency_checkpoint")


@dataclass
class Config:
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(json.load(f))

    def __getitem__(self, key: str) -> Any:
        return self.raw[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.raw.get(key, default)

    def unknown_keys(self) -> list[str]:
        return sorted(k for k in self.raw if k not in KNOWN_KEYS)

    def ignored_keys(self) -> list[str]:
        return [k for k in IGNORED_KEYS if k in self.raw]

    def check_ported(self) -> None:
        """Raise on a ``mesh`` over more than one device: data and model
        parallelism are not ported yet (ROADMAP.md, queue 1, item 7)."""
        spec = self.raw.get("mesh") or {}
        if spec and (int(spec.get("dp", 0)) or 0) * int(spec.get("mp", 1)) != 1:
            raise NotImplementedError(
                f"mesh {spec} is not ported yet: the port trains and serves on "
                "one device (ROADMAP.md, queue 1, item 7)"
            )

    @property
    def model_name(self) -> str:
        return self.raw.get("model_name", "resnet50")

    @property
    def num_classes(self) -> int:
        return int(self.raw.get("num_classes", 1))

    @property
    def batch_size(self) -> int:
        return int(self.raw.get("batch_size", 128))

    @property
    def num_epochs(self) -> int:
        return int(self.raw.get("num_epochs", 10))

    @property
    def weight_decay(self) -> float:
        return float(self.raw.get("weight_decay", 0.0))

    @property
    def reference_parity(self) -> bool:
        return bool(self.raw.get("reference_parity", True))

    @property
    def log_interval(self) -> int:
        return int(self.raw.get("log_interval", 100))

    @property
    def img_size(self) -> int:
        return int(self.raw.get("img_size", 224))

    @property
    def task(self) -> str:
        return self.raw.get("task", "classification")

    @property
    def aggregator(self) -> str:
        return self.raw.get("aggregator", "identity")

    @property
    def n_layers_to_train(self) -> int:
        return int(self.raw.get("n_layers_to_train", 100))

    @property
    def compute_dtype(self) -> str:
        return self.raw.get("compute_dtype", "float32")
