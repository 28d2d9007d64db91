"""Persistence: save/load of fitted models, predictions and CV objects.

Equivalent of ``save.bigKRLS`` / ``load.bigKRLS`` and their helpers
``make_path``, ``bSave``, ``bLoad`` (``R/bigKRLS.R:901-1017``,
``R/bigKRLS_Rcpp_functions.R:273-379``), redesigned for a JAX runtime:

* the reference writes each big matrix to a **text** file
  (``write.big.matrix``) plus an ``estimates.RData`` blob; here every array
  goes into a single compressed ``arrays.npz`` (binary, lossless f64) and
  scalars/metadata into ``meta.json`` — orders of magnitude smaller and
  faster, with no RData/descriptor-file machinery;
* when the optional native extension is built (``native/matstore.cpp``),
  N×N matrices above ``MMAP_THRESHOLD`` elements are streamed to raw
  binary ``.bin`` files through the C++ writer and loaded back zero-copy
  via ``numpy.memmap`` — the replacement for bigmemory's
  file-backed matrices;
* folder-name collision handling mirrors ``make_path``: without
  ``overwrite_existing`` an integer suffix is appended
  (``R/bigKRLS_Rcpp_functions.R:278-288``);
* CV objects recurse per fold into ``fold_k/trained`` and
  ``fold_k/tested`` subfolders like the reference (``R/bigKRLS.R:919-931``).
"""
from __future__ import annotations


import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .crossvalidate import KRLSCrossValidation, KRLSFold
from .types import FactoredCovariance, KRLSModel, KRLSPrediction

MMAP_THRESHOLD = 4_000_000  # elements; above this prefer raw-binary streaming

_MODEL_ARRAYS = [
    "X", "y", "K", "coeffs", "yfitted", "K_eigenvalues", "derivatives",
    "avgderivatives", "var_avgderivatives", "binaryindicator",
    "x_means", "x_sds", "eig_tail_theta", "eig_tail_w",
]
_MODEL_SCALARS = [
    "sigma", "lambda_", "looe", "R2", "R2AME", "lastkeeper", "neffective",
    "neffective_acf", "sigmasq_std", "y_mean", "y_sd",
]
_PRED_ARRAYS = ["predicted", "se_pred", "newdata", "newdataK", "ytest",
                "vcov_est_pred"]


def _unique_path(path: str, overwrite_existing: bool) -> str:
    if overwrite_existing or not os.path.exists(path):
        return path
    i = 1
    while os.path.exists(f"{path}{i}"):
        i += 1
    return f"{path}{i}"


def _save_arrays(folder: str, arrays: Dict[str, np.ndarray]) -> None:
    big, small = {}, {}
    try:
        from .native.matstore import write_matrix, available as _native_ok
        native = _native_ok()
    except Exception:
        native = False
    for name, arr in arrays.items():
        if arr is None:
            continue
        arr = np.asarray(arr)
        if native and arr.size >= MMAP_THRESHOLD and arr.dtype == np.float64:
            big[name] = arr
        else:
            small[name] = arr
    np.savez_compressed(os.path.join(folder, "arrays.npz"), **small)
    if big:
        from .native.matstore import write_matrix
        for name, arr in big.items():
            write_matrix(os.path.join(folder, f"{name}.bin"),
                         np.ascontiguousarray(arr))
        with open(os.path.join(folder, "bigmats.json"), "w") as fh:
            json.dump({name: list(arr.shape) for name, arr in big.items()}, fh)


def _load_arrays(folder: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    npz_path = os.path.join(folder, "arrays.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as data:
            out.update({k: data[k] for k in data.files})
    bm_path = os.path.join(folder, "bigmats.json")
    if os.path.exists(bm_path):
        with open(bm_path) as fh:
            shapes = json.load(fh)
        for name, shape in shapes.items():
            out[name] = np.memmap(os.path.join(folder, f"{name}.bin"),
                                  dtype=np.float64, mode="r",
                                  shape=tuple(shape))
    return out


def _save_one(obj, folder: str) -> None:
    os.makedirs(folder, exist_ok=True)
    if isinstance(obj, KRLSModel):
        arrays = {name: getattr(obj, name) for name in _MODEL_ARRAYS}
        fac = obj.vcov_c_factored
        if fac is not None:
            arrays["vcov_Q"] = fac.Q
            arrays["vcov_spectrum"] = fac.spectrum
        meta: Dict[str, Any] = {"class": "KRLSModel",
                                "xlabs": list(obj.xlabs),
                                "which_derivatives": obj.which_derivatives,
                                "eig_path": obj.eig_path}
        for name in _MODEL_SCALARS:
            meta[name] = getattr(obj, name)
        if fac is not None:
            meta["vcov_scale"] = fac.scale
    elif isinstance(obj, KRLSPrediction):
        arrays = {name: getattr(obj, name) for name in _PRED_ARRAYS}
        meta = {"class": "KRLSPrediction", "pseudoR2": obj.pseudoR2,
                "MSE": obj.MSE}
    else:
        raise TypeError(f"cannot save object of type {type(obj)}")
    _save_arrays(folder, arrays)
    with open(os.path.join(folder, "meta.json"), "w") as fh:
        json.dump(meta, fh, default=float)


def save_model(obj, path: str, overwrite_existing: bool = False,
               noisy: bool = False) -> str:
    """Save a KRLSModel, KRLSPrediction or KRLSCrossValidation to a folder.

    Returns the folder actually used (integer-suffixed on collision unless
    ``overwrite_existing``, like the reference's ``make_path``).
    """
    path = _unique_path(path, overwrite_existing)
    os.makedirs(path, exist_ok=True)
    if isinstance(obj, KRLSCrossValidation):
        meta: Dict[str, Any] = {
            "class": "KRLSCrossValidation", "type": obj.type,
            "seed": obj.seed, "kfolds": obj.kfolds, "ptesting": obj.ptesting,
            "metrics": {k: (np.asarray(v).tolist()
                            if isinstance(v, np.ndarray) else v)
                        for k, v in obj.metrics.items()},
            "n_folds_saved": len(obj.fold_results),
        }
        if obj.folds is not None:
            meta["folds"] = obj.folds.tolist()
        if obj.indices is not None:
            meta["indices"] = {k: v.tolist() for k, v in obj.indices.items()}
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh, default=float)
        for k, fold in enumerate(obj.fold_results):
            _save_one(fold.trained, os.path.join(path, f"fold_{k + 1}",
                                                 "trained"))
            _save_one(fold.tested, os.path.join(path, f"fold_{k + 1}",
                                                "tested"))
    else:
        _save_one(obj, path)
    if noisy:
        total = sum(os.path.getsize(os.path.join(dp, f))
                    for dp, _, fs in os.walk(path) for f in fs)
        print(f"Saved to {path} ({total / 1024**2:.1f} MB)")
    return path


def _load_one(folder: str):
    with open(os.path.join(folder, "meta.json")) as fh:
        meta = json.load(fh)
    arrays = _load_arrays(folder)
    cls = meta["class"]
    if cls == "KRLSModel":
        fac = None
        if "vcov_Q" in arrays:
            fac = FactoredCovariance(arrays["vcov_Q"],
                                     arrays["vcov_spectrum"],
                                     meta.get("vcov_scale", 1.0))
        def g(name):
            return arrays.get(name)
        return KRLSModel(
            X=g("X"), y=g("y"), K=g("K"), xlabs=meta["xlabs"],
            coeffs=g("coeffs"), yfitted=g("yfitted"),
            sigma=meta["sigma"], lambda_=meta["lambda_"], looe=meta["looe"],
            R2=meta["R2"], R2AME=meta.get("R2AME"),
            K_eigenvalues=g("K_eigenvalues"),
            lastkeeper=int(meta["lastkeeper"]),
            neffective=meta["neffective"],
            neffective_acf=meta.get("neffective_acf"),
            derivatives=g("derivatives"), avgderivatives=g("avgderivatives"),
            var_avgderivatives=g("var_avgderivatives"),
            binaryindicator=np.asarray(g("binaryindicator"), dtype=bool),
            which_derivatives=meta.get("which_derivatives"),
            vcov_c_factored=fac, sigmasq_std=meta.get("sigmasq_std"),
            y_mean=meta["y_mean"], y_sd=meta["y_sd"],
            x_means=g("x_means"), x_sds=g("x_sds"), path=folder,
            eig_path=meta.get("eig_path"),
            eig_tail_theta=g("eig_tail_theta"), eig_tail_w=g("eig_tail_w"),
        )
    if cls == "KRLSPrediction":
        return KRLSPrediction(
            predicted=arrays.get("predicted"),
            se_pred=arrays.get("se_pred"),
            newdata=arrays.get("newdata"),
            newdataK=arrays.get("newdataK"),
            ytest=arrays.get("ytest"),
            vcov_est_pred=arrays.get("vcov_est_pred"),
            pseudoR2=meta.get("pseudoR2"), MSE=meta.get("MSE"),
        )
    raise ValueError(f"unknown class in meta.json: {cls}")


def load_model(path: str):
    """Load whatever ``save_model`` wrote at ``path``."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("class") != "KRLSCrossValidation":
        return _load_one(path)
    fold_results = []
    for k in range(meta["n_folds_saved"]):
        trained = _load_one(os.path.join(path, f"fold_{k + 1}", "trained"))
        tested = _load_one(os.path.join(path, f"fold_{k + 1}", "tested"))
        fold_results.append(KRLSFold(trained, tested))
    metrics = {k: (np.asarray(v) if isinstance(v, list) else v)
               for k, v in meta["metrics"].items()}
    return KRLSCrossValidation(
        type=meta["type"], seed=meta["seed"],
        folds=(np.asarray(meta["folds"]) if "folds" in meta else None),
        indices=({k: np.asarray(v) for k, v in meta["indices"].items()}
                 if "indices" in meta else None),
        fold_results=fold_results, metrics=metrics,
        kfolds=meta.get("kfolds"), ptesting=meta.get("ptesting"),
    )
