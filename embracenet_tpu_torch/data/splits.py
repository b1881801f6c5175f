"""Train/test/validation split logic (reference parity): the port's own copy
of ``embracenet_tpu/data/splits.py``.

Mirrors ``Data_Prepare.split_data`` / ``return_data`` /
``return_index_data_for_cv`` (`BIOINF_tesi/data_pipe/dataprepare.py:197-366`):

  * model-testing split: ``train_test_split(test_size=0.25, shuffle=True,
    random_state)``;
  * hyper-tuning split: a further ``test_size=0.15`` split of the training
    set with ``random_state + 100`` (the test set is discarded);
  * CV indices: ``KFold(n_splits, shuffle=True, random_state)``.

Splits operate on row indices so tabular and sequence views stay aligned
(replacing the reference's index_fa DataFrame bookkeeping).
"""

from __future__ import annotations

import numpy as np

from embracenet_tpu_torch.utils.skcompat import kfold_split, train_test_split


def split_indices(n: int, hyper_tuning: bool = False, test_size: float = 0.25,
                  validation_size: float = 0.15, random_state: int = 123):
    """-> (train_idx, test_idx).  With ``hyper_tuning`` the returned "test"
    is the validation subset of the training split (reference
    `dataprepare.py:197-261`)."""
    idx = np.arange(n)
    tr, te = train_test_split(idx, test_size=test_size,
                              random_state=random_state)
    if hyper_tuning:
        tr, te = train_test_split(tr, test_size=validation_size,
                                  random_state=random_state + 100)
    return tr, te


def split_data(data: dict, hyper_tuning: bool = False, test_size: float = 0.25,
               validation_size: float = 0.15, random_state: int = 123,
               augmentation: bool = False):
    """-> (train dict, test dict) over all views of a data dict
    ({"ffnn": ..., "cnn": ..., "y": ...}); optional training-set
    augmentation (reference ``return_data`` `dataprepare.py:320-366`)."""
    n = len(np.asarray(data["y"]))
    tr, te = split_indices(n, hyper_tuning, test_size, validation_size,
                           random_state)
    train = {k: np.asarray(v)[tr] for k, v in data.items()}
    test = {k: np.asarray(v)[te] for k, v in data.items()}
    if augmentation:
        from embracenet_tpu_torch.data.sampling import data_augmentation

        y = train["y"]
        for view in [k for k in train if k != "y"]:
            train[view], new_y = data_augmentation(
                train[view], y, sequence=(view == "cnn"))
        train["y"] = np.asarray(new_y)
    return train, test


def cv_indices(n: int, n_folds: int = 3, random_state: int = 123):
    """KFold index pairs (reference ``return_index_data_for_cv``,
    `dataprepare.py:264-306`)."""
    return kfold_split(n, n_folds, random_state)
