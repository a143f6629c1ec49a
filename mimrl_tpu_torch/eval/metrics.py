"""Evaluation metrics (host-side numpy; the port's copy of
``mimrl_tpu.eval.metrics``).

Reproduces the reference metric battery (ref: Utils.py:118-175,
Solver.py:344-423). ``accuracy_score``, the support-weighted
``f1_score`` and ``mean_absolute_error`` are reimplemented in numpy with
scikit-learn's semantics, so the port needs no scikit-learn.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


# --- scikit-learn metric counterparts ---------------------------------- #

def accuracy_score(y_true, y_pred) -> float:
    """Fraction of exact label matches (sklearn.metrics.accuracy_score)."""
    return float(np.mean(np.asarray(y_true).reshape(-1)
                         == np.asarray(y_pred).reshape(-1)))


def f1_score_weighted(y_true, y_pred) -> float:
    """Per-label F1 averaged with the labels' support as weights
    (sklearn.metrics.f1_score(..., average="weighted")); a label with no
    true or predicted positives scores 0."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    labels = np.union1d(y_true, y_pred)
    f1 = np.zeros(len(labels))
    support = np.zeros(len(labels))
    for i, lab in enumerate(labels):
        t, p = y_true == lab, y_pred == lab
        tp = np.sum(t & p)
        denom = 2 * tp + np.sum(~t & p) + np.sum(t & ~p)
        f1[i] = 2 * tp / denom if denom else 0.0
        support[i] = np.sum(t)
    return float(np.average(f1, weights=support))


def mean_absolute_error(y_true, y_pred) -> float:
    """sklearn.metrics.mean_absolute_error for 1-D targets."""
    return float(np.average(np.abs(np.asarray(y_pred) - np.asarray(y_true))))


# --- reference r2c helpers (data/local.py, data/sdk.py) ----------------- #

def r2c_2(a) -> int:
    """Regression score -> binary class (pos vs non-pos)."""
    return int(a > 0)


def r2c_7(a) -> int:
    """Regression score -> 7-class in [0, 6], clipped to [-3, 3]."""
    return int(np.clip(np.round(a), -3, 3)) + 3


def mosi_r2c_7(a):
    """Regression score -> 7-class (ref: DataLoaderCMUSDK.py:32-33)."""
    return np.int64(np.round(a)) + 3


def pom_r2c_7(a):
    """[1,7] -> 7-class (ref: DataLoaderCMUSDK.py:35-51)."""
    for res, upper in enumerate((2, 3, 4, 5, 6, 7)):
        if a < upper:
            return res
    return 6


# --- the reference battery ---------------------------------------------- #

def multiclass_acc(preds, truths) -> float:
    """(ref: Utils.py:100-101)"""
    return float(np.sum(np.round(preds) == np.round(truths)) / len(truths))


def ccc_score(x, y) -> float:
    """Concordance correlation coefficient (ref: Utils.py:37-49)."""
    x, y = np.reshape(x, -1), np.reshape(y, -1)
    x_mean, y_mean = np.nanmean(x), np.nanmean(y)
    covariance = np.nanmean((x - x_mean) * (y - y_mean))
    x_var = np.nanmean((x - x_mean) ** 2)
    y_var = np.nanmean((y - y_mean) ** 2)
    return float(2 * covariance / (x_var + y_var + (x_mean - y_mean) ** 2))


def rmse_score(output, target) -> float:
    """(ref: Utils.py:278-279)"""
    return float(np.sqrt(np.mean((np.asarray(output) - np.asarray(target)) ** 2)))


def _binary_battery(test_truth, test_preds) -> Dict[str, float]:
    """Acc-2 and weighted F1 in the pos/neg (zero labels excluded) and
    non-neg/neg conventions."""
    non_zeros = np.nonzero(test_truth != 0)[0]
    truth_pn = test_truth[non_zeros] > 0
    preds_pn = test_preds[non_zeros] > 0
    truth_nn = test_truth >= 0
    preds_nn = test_preds >= 0
    return {
        "2(pos/neg)-class_acc": accuracy_score(truth_pn, preds_pn),
        "2(nneg/neg)-class_acc": accuracy_score(truth_nn, preds_nn),
        "2(pos/neg)-class_f1": f1_score_weighted(truth_pn, preds_pn),
        "2(nneg/neg)-class_f1": f1_score_weighted(truth_nn, preds_nn),
    }


def calc_metrics(y_true, y_pred) -> Dict[str, float]:
    """MOSI/MOSEI metric battery (ref: Utils.py:118-175)."""
    test_truth = np.reshape(np.asarray(y_true), -1)
    test_preds = np.reshape(np.asarray(y_pred), -1)
    result = {
        "mae": float(np.mean(np.absolute(test_preds - test_truth))),
        "corr": float(np.corrcoef(test_preds, test_truth)[0][1]),
        "7-class_acc": multiclass_acc(np.clip(test_preds, -3.0, 3.0),
                                      np.clip(test_truth, -3.0, 3.0)),
        "5-class_acc": multiclass_acc(np.clip(test_preds, -2.0, 2.0),
                                      np.clip(test_truth, -2.0, 2.0)),
    }
    result.update(_binary_battery(test_truth, test_preds))
    return result


def calc_metrics_pom(y_true, y_pred) -> Dict[str, float]:
    """POM metric battery (ref: Utils.py:178-223)."""
    test_truth = np.reshape(np.asarray(y_true), -1)
    test_preds = np.reshape(np.asarray(y_pred), -1)
    result = {
        "mae": float(np.mean(np.absolute(test_preds - test_truth))),
        "corr": float(np.corrcoef(test_preds, test_truth)[0][1]),
    }
    result.update(_binary_battery(test_truth, test_preds))
    return result


def get_score_from_result(predictions: np.ndarray, targets: np.ndarray,
                          dataset: str, task: str,
                          num_class: int) -> Dict[str, float]:
    """Per-dataset score routing (ref: Solver.py:344-423)."""
    predictions = np.asarray(predictions)
    targets = np.asarray(targets)

    if task == "classification":
        if num_class == 1:
            preds_c = np.int64(predictions.reshape(-1) > 0)
        else:
            preds_c = np.argmax(predictions.reshape(-1, num_class), axis=1)
        preds_c, targets_c = preds_c.reshape(-1), targets.reshape(-1)
        return {
            f"{num_class}-class_acc": accuracy_score(targets_c, preds_c),
            f"{num_class}-f1": f1_score_weighted(targets_c, preds_c),
        }

    if task != "regression":
        raise ValueError(f"unknown task {task!r}")
    preds, targs = predictions.reshape(-1), targets.reshape(-1)
    mae = mean_absolute_error(targs, preds)
    corr = float(np.corrcoef(preds, targs)[0][1])

    if dataset in ("mosi_20", "mosi_50", "mosei_20", "mosei_50"):
        bucket7 = mosi_r2c_7 if "mosi" in dataset else r2c_7
        p7 = [bucket7(p) for p in preds]
        t7 = [bucket7(p) for p in targs]
        p2 = [r2c_2(p) for p in preds]
        t2 = [r2c_2(p) for p in targs]
        return {
            "mae": mae,
            "corr": corr,
            "7-class_acc": accuracy_score(t7, p7),
            "2-class_acc": accuracy_score(t2, p2),
            "7-f1": f1_score_weighted(t7, p7),
            "2-f1": f1_score_weighted(t2, p2),
        }
    if dataset in ("mosi_SDK", "mosei_SDK", "mosi_Dec", "mosei_Dec"):
        return calc_metrics(targs, preds)
    if dataset == "pom_SDK":
        return calc_metrics_pom(targs, preds)
    if dataset == "pom":
        p7 = [pom_r2c_7(p) for p in preds]
        t7 = [pom_r2c_7(p) for p in targs]
        return {
            "mae": mae,
            "corr": corr,
            "7-class_acc": accuracy_score(t7, p7),
            "7-f1": f1_score_weighted(t7, p7),
        }
    if dataset in ("mmmo", "mmmov2"):
        p2 = [int(p >= 3.5) for p in preds]
        t2 = [int(p >= 3.5) for p in targs]
        return {
            "mae": mae,
            "corr": corr,
            "2-class_acc": accuracy_score(t2, p2),
            "2-f1": f1_score_weighted(t2, p2),
        }
    if dataset in ("youtube", "youtubev2", "moud", "iemocap_20"):
        return {"mae": mae, "corr": corr}
    if dataset == "avec2019":
        return {
            "mae": mae,
            "ccc": ccc_score(preds, targs),
            "rmse": rmse_score(preds * 25, targs * 25),
        }
    raise NotImplementedError(dataset)
