"""Training: SAM optimizer, tile dataset, experiment harness.

(reference: cnn/training/experiment_script_all.py + the davda54/sam
submodule the reference depends on)
"""

from .sam import (make_sam_train_step, make_sgd_train_step,
                  make_inner_optimizer, weighted_cross_entropy,
                  sam_perturbation, step_lr)
from .data import (TiledDataset, TRAIN_CAMPAIGN_NORM, load_labels_csv,
                   loss_weights_for, augment_batch)
from .train import (TrainConfig, train_experiment, evaluate_threshold,
                    make_model, save_checkpoint, load_checkpoint, load_into,
                    save_checkpoint_pt, load_checkpoint_pt)
