"""The local dataset cache the port's dataset readers resolve from:
``~/.cache/paddle/dataset``, the reference's root (its
``utils.dataset_cache_path``), so a file placed for one package serves
both. Nothing is downloaded."""
from __future__ import annotations

import os

DATASET_HOME = os.path.join("~", ".cache", "paddle", "dataset")


def dataset_cache_path(filename):
    """``filename`` under the dataset cache (``~`` expanded now, so a
    changed ``HOME`` is seen)."""
    return os.path.join(os.path.expanduser(DATASET_HOME), filename)
