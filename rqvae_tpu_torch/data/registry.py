"""Dataset registry (port of rqvae_tpu/data/registry.py).

The RecDataset enum, the per-dataset history lengths, and `ensure_dataset`:
SYNTHETIC is generated on first use; the other datasets load an existing
`processed/data.npz`, since their preprocessing pipelines are not ported.
"""

from __future__ import annotations

import enum
import os
from typing import Optional


class RecDataset(enum.Enum):
    AMAZON = 1
    ML_1M = 2
    ML_32M = 3
    SYNTHETIC = 4


DATASET_MAX_SEQ_LEN = {
    RecDataset.AMAZON: 20,
    RecDataset.ML_1M: 200,
    RecDataset.ML_32M: 200,
    RecDataset.SYNTHETIC: None,  # taken from the generated file
}

_STAMPS = {
    RecDataset.AMAZON: "amazon",
    RecDataset.ML_1M: "ml1m",
    RecDataset.ML_32M: "ml32m",
    RecDataset.SYNTHETIC: "synthetic",
}


def ensure_dataset(root: str, dataset: RecDataset, split: Optional[str] = None, force: bool = False) -> dict:
    """Load the processed npz of a dataset, generating SYNTHETIC if it is
    missing (or `force`). A real dataset must already be preprocessed at
    `root`: its pipeline is not part of this package."""
    from rqvae_tpu_torch.data.datasets import load_processed

    path = os.path.join(root, "processed", "data.npz")
    if dataset == RecDataset.SYNTHETIC:
        if force or not os.path.exists(path):
            from rqvae_tpu_torch.data.synthetic import generate_and_save

            generate_and_save(root)
    elif dataset not in _STAMPS:
        raise ValueError(f"Unknown dataset {dataset}")
    elif force or not os.path.exists(path):
        raise NotImplementedError(
            f"{path} is missing and the {_STAMPS[dataset]} preprocessing pipeline is not ported: "
            "preprocess the dataset with the rqvae_tpu package and point dataset_folder at the result"
        )
    data = load_processed(root)
    _check_stamp(data, dataset, split, root)
    return data


def _check_stamp(data: dict, dataset: RecDataset, split: Optional[str], root: str) -> None:
    """Refuse an npz produced for another dataset or Amazon split at the same
    root (each pipeline stamps dataset_name / dataset_split into the file;
    unstamped files pass)."""
    name = str(data["dataset_name"]) if "dataset_name" in data else None
    want = _STAMPS[dataset]
    if name is not None and name != want:
        raise ValueError(
            f"{root}/processed/data.npz was produced by the '{name}' pipeline "
            f"but dataset={want} was requested; use a different dataset_folder "
            "or force=True to reprocess"
        )
    if dataset == RecDataset.AMAZON and split and "dataset_split" in data:
        have = str(data["dataset_split"])
        if have != split:
            raise ValueError(
                f"{root}/processed/data.npz holds the Amazon '{have}' split "
                f"but split='{split}' was requested; use a different "
                "dataset_folder or force=True to reprocess"
            )
