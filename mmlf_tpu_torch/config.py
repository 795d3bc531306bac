"""Configuration: one dataclass holds every hyper-parameter.

Field names and defaults are those of ``mmlf_tpu.config.Config`` (which in
turn match the reference CLI), so a checkpoint's ``hyper_parameters`` dict
means the same thing to both packages.  The validate CLI rebuilds the model
from the stored config, with CLI flags overriding only ``model_discrete``,
the disparity range and ``train_shift``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # --- model ---
    model_ksize: int = 2
    model_in_blocks: int = 3
    model_out_blocks: int = 8
    model_chs: int = 70
    model_views: int = 9
    model_cross: bool = False
    model_uncert: bool = False
    model_discrete: bool = False
    model_unet: bool = False
    model_invertible: bool = False
    model_clamp: float = 0.7
    model_act_norm: float = 0.7
    model_act_norm_type: str = 'SOFTPLUS'
    model_soft_permutation: bool = False
    model_no_batchnorm: bool = False
    model_batchnorm_momentum: float = 0.1

    # --- training ---
    train_trainset: str = '../lf-dataset/additional'
    train_valset: str = '../lf-dataset/training'
    train_no_data_augment: bool = False
    train_num_workers: int = 4
    train_lr: float = 1e-5
    train_bs: int = 1
    train_ps: int = 32
    train_beta: float = 1.0
    train_mae_threshold: float = 0.02
    train_max_downscale: int = 4
    train_resume: bool = False
    train_loss_padding: Optional[float] = None
    train_shift: float = 0.0
    train_loss_multimodal: bool = False
    train_loss_strongest: bool = False
    train_eval_mode: bool = False
    train_eval_mode_start: int = 0
    train_warm_start: bool = False
    train_cooling: int = 0

    # --- validation ---
    val_interval: int = 100
    val_loss_margin: int = 15
    val_ensamble: bool = False
    val_disp_min: float = -3.5
    val_disp_max: float = 3.5
    val_disp_step: float = 0.1

    # --- derived (filled by finalize(); stored for checkpoint parity) ---
    model_radius: int = 0

    # --- extensions of mmlf_tpu, kept so stored configs round-trip ---
    mesh_data: int = 0
    train_seed: int = 0
    train_steps: int = 0
    bf16: bool = False
    cache_bf16: bool = False
    host_pipeline: bool = False
    remat: bool = False
    pallas_trunk: bool = False
    train_accum: int = 1
    train_accum_exact: bool = False
    train_profile: bool = False
    train_nan_guard: bool = False
    train_logvar_warmup: int = 0
    train_logvar_anchor: float = 0.0
    train_term_checkpoint: bool = True
    model_inn: bool = False

    def finalize(self) -> 'Config':
        """Apply the derived-value rules: ``model_radius`` is derived, and
        ``val_ensamble`` implies ``model_uncert``."""
        self.model_radius = (self.model_in_blocks + self.model_out_blocks) * \
            ((self.model_ksize + 1) // 2)
        if self.val_ensamble:
            self.model_uncert = True
        return self

    @property
    def steps(self) -> int:
        """Number of discrete disparity bins."""
        s = 2 if self.model_cross else 4
        return s * self.model_views * 3

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> 'Config':
        """Build a Config from a flat dict, ignoring unknown keys."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
