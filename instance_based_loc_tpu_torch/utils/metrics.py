"""Localisation error metrics and binned result reports (counterpart of
`instance_based_loc_tpu/utils/metrics.py`; reference
`tum_localisation_trial.py:229-344`): translation / rotation bins, averages,
medians, SUCCESS := trans < 0.6 m AND rot < 0.3 rad."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.transforms import quaternion_error

TRANS_BINS = (0.1, 0.3, 0.6, 1.0, 1.5, 3.0)
ROT_BINS = (0.1, 0.3, 0.6, 1.0, 1.5)
SUCCESS_TRANS = 0.6
SUCCESS_ROT = 0.3


def pose_errors(target_pose: np.ndarray, estimated_pose: np.ndarray):
    """(translation_error, rotation_error) with the reference conventions:
    the norm of the position delta, and `quaternion_error` on the [3:]
    components in float32, as the JAX package computes it."""
    trans = float(np.linalg.norm(np.asarray(target_pose[:3])
                                 - np.asarray(estimated_pose[:3])))
    rot = float(quaternion_error(
        torch.as_tensor(np.asarray(target_pose[3:]), dtype=torch.float32),
        torch.as_tensor(np.asarray(estimated_pose[3:]), dtype=torch.float32)))
    return trans, rot


def is_success(trans_err: float, rot_err: float) -> bool:
    return trans_err < SUCCESS_TRANS and rot_err < SUCCESS_ROT


def format_results_report(trans_errors, rot_errors, assignments=None) -> str:
    """The reference's results.txt format (tum_localisation_trial.py:255-344)."""
    trans_errors = list(map(float, trans_errors))
    rot_errors = list(map(float, rot_errors))
    n = len(trans_errors)
    assignments = assignments or [[None, None]] * n
    lines = []
    successes = 0
    for i, (te, re_, assn) in enumerate(zip(trans_errors, rot_errors,
                                            assignments)):
        lines += [f"Pose {i + 1}, image {n}",
                  f"Translation error: {te}",
                  f"Rotation errors: {re_}",
                  f"Assignment: {assn[0]}",
                  f"Moved objects: {assn[1]}"]
        if is_success(te, re_):
            lines.append("SUCCESS")
            successes += 1
        else:
            lines.append("MISALIGNED")
        lines.append("")

    lines.append(f"Bagged results for {n} eval indices")
    for b in TRANS_BINS:
        lines.append(f"Translation error less than {b}: "
                     f"{sum(1 for t in trans_errors if t < b)}")
    lines.append(f"Translation error greater than {TRANS_BINS[-1]}: "
                 f"{sum(1 for t in trans_errors if t >= TRANS_BINS[-1])}")
    lines.append("")
    for b in ROT_BINS:
        lines.append(f"Rotation error less than {b}: "
                     f"{sum(1 for r in rot_errors if r < b)}")
    lines.append(f"Rotation error greater than {ROT_BINS[-1]}: "
                 f"{sum(1 for r in rot_errors if r >= ROT_BINS[-1])}")
    lines.append("")
    if n:
        lines += [f"Average Translation Error: {np.mean(trans_errors)}",
                  f"Average Rotation Error: {np.mean(rot_errors)}",
                  f"Median Translation Error: {np.median(trans_errors)}",
                  f"Median Rotation Error: {np.median(rot_errors)}",
                  f"Total Success Rate: {successes / n * 100}"]
    return "\n".join(lines) + "\n"
