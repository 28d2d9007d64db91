"""bigkrls_tpu — a JAX Kernel Regularized Least Squares framework.

A from-scratch JAX/XLA re-design with the full capabilities of the
reference R package bigKRLS (rdrr1990/bigKRLS; see SURVEY.md): Gaussian
KRLS with exact leave-one-out golden-section tuning of the ridge penalty,
full/truncated symmetric eigendecomposition, pointwise and average marginal
effects (exact first differences for binary predictors), effective-sample-
size-corrected inference, prediction with uncertainty, train/test and
K-fold cross-validation, persistence, and multi-device sharding over a
``jax.sharding.Mesh``.

Public API (reference equivalents in parentheses):

* ``fit`` / ``bigKRLS``            (``bigKRLS()``)
* ``predict``                      (``predict.bigKRLS``)
* ``summary``                      (``summary.bigKRLS``)
* ``crossvalidate``                (``crossvalidate.bigKRLS``)
* ``summary_cv``                   (``summary.bigKRLS_CV``)
* ``save_model`` / ``load_model``  (``save.bigKRLS`` / ``load.bigKRLS``)
* ``plot_effects``                 (``shiny.bigKRLS`` — static/notebook plot)
* ``effects_explorer``             (``shiny.bigKRLS`` — interactive HTML app)
* ``enable_x64``                   parity-mode helper (f64 everywhere)
"""
from __future__ import annotations

import jax as _jax

from .model import bigKRLS, check_data, fit
from .inference import KRLSSummary, summary
from .predict import predict
from .types import (Eigensystem, FactoredCovariance, KRLSModel,
                    KRLSPrediction)

__version__ = "0.1.0"


def enable_x64() -> None:
    """Enable float64 (parity mode vs the all-double reference).

    With x64 on, ``fit`` defaults to f64 unless ``dtype`` says otherwise.
    """
    _jax.config.update("jax_enable_x64", True)


# note: persistence imports crossvalidate, and the `crossvalidate` and
# `reducibility` functions deliberately shadow their submodules in the
# package namespace
from .crossvalidate import KRLSCrossValidation, summary_cv
from .crossvalidate import crossvalidate as _crossvalidate_fn
from .explorer import effects_explorer
from .persistence import load_model, save_model
from .plotting import export_effects, plot_effects
from .reducibility import reducibility as _reducibility_fn

crossvalidate = _crossvalidate_fn
reducibility = _reducibility_fn
