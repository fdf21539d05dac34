"""Learned-predictor subsystem (port of ``repro.learn``): trace-driven
training of ``family="pc"`` DVFS mechanisms.

The pipeline is train -> freeze -> register -> sweep:

1. ``learn.dataset`` runs ``run_grid`` over workloads x seeds x epoch
   granularities as a labeled-data factory (oracle choices are the
   labels; on the card the PCSTALL rows step on the fork family's fused
   epoch kernel) with deterministic by-run train/val splits;
2. ``learn.models`` + ``learn.train`` fit a linear I(f) head and a tiny
   MLP with cosine-LR AdamW (``optim.adamw``, ``torch.autograd``), folding
   feature normalization into the frozen raw-space weights;
3. ``learn.mechanism`` registers the frozen weights as ``learned_lin`` /
   ``learned_mlp`` pc-family specs (``ParamHook``: value-keyed, audited)
   that sweep like any builtin.

``python -m repro_torch.learn`` runs the pipeline end to end, on the card
unless ``--device cpu`` is given. Frozen weights are the reference's npz
layout: either package loads the other's artifact.
"""
from repro_torch.learn.dataset import (DatasetConfig, choice_accuracy,
                                       generate_dataset, load_dataset,
                                       save_dataset, select_fidx,
                                       split_masks)
from repro_torch.learn.mechanism import (LEARNED_AXES, epoch_features,
                                         learned_predict, learned_update,
                                         make_learned_spec, register_learned)
from repro_torch.learn.models import (APPLY, FEATURE_NAMES, INIT, N_FEATURES,
                                      N_TARGETS, REACT_BETA, REACT_COLS,
                                      TARGET_NAMES, apply_model, fold_norm,
                                      init_linear, init_mlp, kind_of,
                                      linear_apply, mlp_apply,
                                      predict_targets)
from repro_torch.learn.train import (default_tc, fit, load_weights,
                                     make_train_step, norm_stats,
                                     reactive_choice_baseline, save_weights)

__all__ = [
    "DatasetConfig", "choice_accuracy", "generate_dataset", "load_dataset",
    "save_dataset", "select_fidx", "split_masks",
    "LEARNED_AXES", "epoch_features", "learned_predict", "learned_update",
    "make_learned_spec", "register_learned",
    "APPLY", "FEATURE_NAMES", "INIT", "N_FEATURES", "N_TARGETS",
    "REACT_BETA", "REACT_COLS", "TARGET_NAMES", "apply_model",
    "fold_norm", "init_linear", "init_mlp", "kind_of", "linear_apply",
    "mlp_apply", "predict_targets",
    "default_tc", "fit", "load_weights", "make_train_step", "norm_stats",
    "reactive_choice_baseline", "save_weights",
]
