"""The grasp trainers' session loop (tcnerf/train/session.py): progress in
`training_progress.json` ({epoch, best_mean_error}), fit rounds of
`eval_after_epochs` epochs, each followed by a validation by pose ascent
whose results pickle to `valid/results-{epoch}.pkl`, and the best model by
the combined score err_t * 1000 + err_r * 180 / pi.

Validation calls the port's `compute_results` on a prepared scene per
sample; its pose optimizer is a `PoseOptimizer` (or anything with its
`reset_optimizer`, `generate_initial_guesses`, `init_state`, `prepare`,
`optimize_pose`, `compute_current_grasp_success` and `get_results`).
`store_fn(path)` writes the checkpoints (`<dir>/best`, `model_final`).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time
from typing import Callable, Dict, List

import numpy as np

from ..data.generators import camera_parameters
from ..opt.pose_optimizer import compute_results
from ..tasks.agents import OracleAgent
from ..utils import wandb_compat as wandb

log = logging.getLogger("tcnerf_torch.train")


# ---------------------------------------------------------------- progress I/O

def init_training_session(model_log_dir: str):
    start_epoch = 0
    progress_file = os.path.join(model_log_dir, "training_progress.json")
    if os.path.exists(progress_file):
        with open(progress_file) as f:
            start_epoch = json.load(f).get("epoch", 0)
    log.info("Starting training from epoch %d", start_epoch)
    return start_epoch, progress_file


def read_best_mean_error(progress_file: str):
    best = [2000, 2000]
    if os.path.exists(progress_file):
        with open(progress_file) as f:
            best = json.load(f).get("best_mean_error", best)
    log.info("Best mean error %s", best)
    return best


def load_training_progress(eval_after_epochs: int, model_log_dir: str,
                           n_epochs: int):
    """(best mean error, number of fit rounds, start epoch, first round,
    progress file)."""
    start_epoch, progress_file = init_training_session(model_log_dir)
    return (read_best_mean_error(progress_file), n_epochs // eval_after_epochs,
            start_epoch, start_epoch // eval_after_epochs, progress_file)


def error_score(mean_error) -> float:
    """Millimetres plus degrees."""
    return mean_error[0] * 1000 + mean_error[1] / np.pi * 180


# ------------------------------------------------------------------ validation

def get_step_results(losses_r, trajectory_r, gt_grasp_pose_h, oracle=None):
    """The five poses of highest final energy, each scored by the oracle
    against the true grasp (best last); an oracle without
    `calculate_error` (the task plugins' oracles) scores through
    `OracleAgent`, as the JAX function does."""
    from scipy.spatial.transform import Rotation

    oracle = oracle or OracleAgent()
    gt = np.asarray(gt_grasp_pose_h)
    gt_pose = [tuple(gt[:3, 3]), tuple(Rotation.from_matrix(
        gt[:3, :3]).as_quat())]
    best_idx = np.argsort(losses_r)[-5:]
    best_poses = [trajectory_r[int(k)] for k in best_idx]
    final_success = [float(losses_r[int(k)]) for k in best_idx]
    score = (oracle if hasattr(oracle, "calculate_error")
             else OracleAgent()).calculate_error
    errors_r = [score(gt_pose, [tuple(pose.translation), tuple(pose.quat)])
                for pose in best_poses]
    return {"grasp_poses": best_poses, "final_success": final_success,
            "errors_r": errors_r}


def validate(pose_optimizer, optimization_config: dict, valid_data: List,
             oracle=None, rng=None):
    """compute_results on each validation sample, scored by
    `get_step_results`."""
    results = []
    for i, (input_data, features, task_info, grasp_pose_h) in enumerate(
            valid_data):
        log.info("Validating on sample %d with %d objects ...", i + 1,
                 len(task_info.keys()))
        losses_t, losses_r, grasps_t, grasps_r, duration, _ = compute_results(
            pose_optimizer, input_data, features, False, rng=rng,
            **optimization_config)
        result = get_step_results(losses_r, grasps_r, grasp_pose_h, oracle)
        results.append(result)
        best = result["errors_r"][-1]
        log.info("   Best    %s    %s", best[0] * 1000, best[1] / np.pi * 180)
    return results


def log_results(epoch: int, results, wandb_initialized: bool):
    """The mean error of every scored pose and the mean of each sample's
    best, in mm and degrees; logged, and to wandb when it runs."""
    r_errors = [r["errors_r"] for r in results]
    mean_r = np.mean(np.concatenate(r_errors, axis=0), axis=0)
    best_mean = np.mean(np.stack([e[-1] for e in r_errors], axis=0), axis=0)
    log_dict = {
        "epoch": epoch,
        "mean_r_error_t": mean_r[0] * 1000,
        "mean_r_error_r": mean_r[1] / np.pi * 180,
        "best_r_error_mean_t": best_mean[0] * 1000,
        "best_r_error_mean_r": best_mean[1] / np.pi * 180,
    }
    log.info("   Average   %s    %s", log_dict["mean_r_error_t"],
             log_dict["mean_r_error_r"])
    log.info("   Best   %s    %s", log_dict["best_r_error_mean_t"],
             log_dict["best_r_error_mean_r"])
    if wandb_initialized:
        wandb.log(log_dict)
    return log_dict


# --------------------------------------------------------------- grasp session

def train_grasp_model(fit_epochs_fn: Callable[[int, int], None],
                      store_fn: Callable[[str], None],
                      n_epochs: int, eval_after_epochs: int,
                      model_log_dir: str, model_checkpoint_name: str,
                      grasp_optimizer, optimization_config: dict,
                      wandb_config: dict, valid_data: List, oracle=None,
                      rng=None, refresh_valid_fn=None) -> Dict[str, List]:
    """Warm-up validation on one sample, then fit rounds of
    `eval_after_epochs` epochs (`fit_epochs_fn(initial, end)`), each
    followed by a validation (with `refresh_valid_fn(valid_data)` first,
    which recomputes the validation features when the feature path
    trains), its results pickled, the best model stored by
    `store_fn(<dir>/best)`, the progress written and the latest stored by
    `store_fn(model_checkpoint_name)`. Returns the history: per validation
    (epoch, its logged errors, its seconds on the host clock), the warm-up
    as epoch None."""
    run, wandb_initialized = wandb.init_wandb(wandb_config)
    best_mean_error, n_fits, start_epoch, start_n_fit, progress_file = \
        load_training_progress(eval_after_epochs, model_log_dir, n_epochs)
    history: Dict[str, List] = {"valid": []}

    t0 = time.perf_counter()
    validate(grasp_optimizer, optimization_config, valid_data[:1], oracle,
             rng)
    history["valid"].append((None, None, time.perf_counter() - t0))

    for k in range(start_n_fit, n_fits):
        i_epoch = k * eval_after_epochs
        e_epoch = (k + 1) * eval_after_epochs
        fit_epochs_fn(i_epoch, e_epoch)

        t0 = time.perf_counter()
        if refresh_valid_fn is not None:
            valid_data = refresh_valid_fn(valid_data)
        results = validate(grasp_optimizer, optimization_config, valid_data,
                           oracle, rng)
        wall = time.perf_counter() - t0
        os.makedirs(os.path.join(model_log_dir, "valid"), exist_ok=True)
        with open(os.path.join(model_log_dir, "valid",
                               f"results-{e_epoch}.pkl"), "wb") as f:
            pickle.dump(results, f)
        logged = log_results(e_epoch, results, wandb_initialized)
        history["valid"].append((e_epoch, logged, wall))

        best_each = [r["errors_r"][-1] for r in results]
        new_mean = list(np.mean(np.stack(best_each, axis=0), axis=0))
        if error_score(new_mean) < error_score(best_mean_error):
            store_fn(os.path.join(model_log_dir, "best"))
            best_mean_error = new_mean
            log.info("New best mean error: %s, %s", best_mean_error[0] * 1000,
                     best_mean_error[1] / np.pi * 180)

        with open(progress_file, "w") as f:
            json.dump({"epoch": e_epoch, "best_mean_error": best_mean_error},
                      f)
        store_fn(model_checkpoint_name)
    if wandb_initialized and run is not None:
        run.finish()
    return history


# ----------------------------------------------------------- validation inputs

def get_inputs(dataset, sample_idx: int, n_images: int, compute_features_fn,
               tokenize_fn=None):
    """One validation sample: the images of views 3-4 (two images) or 0-2,
    their cameras, the instruction's tokens, the features from
    `compute_features_fn(observations, tokens)` pulled to the host (None
    when deferred), the scene's info and the true grasp pose."""
    observations, intrinsics, extrinsics_inv = [], [], []
    tokens = None
    if "language" in dataset.datasets and tokenize_fn is not None:
        text = dataset.datasets["language"].read_sample(sample_idx)
        tokens = np.asarray(tokenize_fn(text), np.int32)

    view_range = range(3, 5) if n_images == 2 else range(0, 3)
    for i in view_range:
        img = dataset.datasets["color"].read_sample_at_idx(
            sample_idx, i)[..., :3] / 255.0
        cfg = dataset.datasets["camera_config"].read_sample_at_idx(
            sample_idx, i)
        ext_inv, k4 = camera_parameters(cfg)
        observations.append(img)
        intrinsics.append(k4)
        extrinsics_inv.append(ext_inv)

    observations = np.asarray([observations], np.float32)
    intrinsics = np.asarray([intrinsics], np.float32)
    extrinsics_inv = np.asarray([extrinsics_inv], np.float32)
    input_data = [observations, intrinsics, extrinsics_inv, tokens]
    # the features stay on the host between validations: one language
    # sample's are [1, 3, 480, 640, 256] f32, ~0.9 GB
    features = compute_features_fn(observations, tokens)
    if features is not None:
        features = np.asarray(features)
    task_info = (dataset.datasets["info"].read_sample(sample_idx)
                 if "info" in dataset.datasets else {})
    grasp_pose = dataset.datasets["grasp_pose"].read_sample(sample_idx)
    if isinstance(grasp_pose, dict):
        grasp_pose = grasp_pose["grasp_pose"]
    return input_data, features, task_info, grasp_pose
