"""Raw data ingestion (port of ``embracenet_tpu/data/io.py``): per-cell-line
CSV (epigenomic features), BED (labels), FASTA (256-bp windows).

Layout parity with `BIOINF_tesi/data_pipe/dataload.py:35-110`
(``Load_Create_Task.data_loader``/``load``): a directory with ``enhancers/``
and ``promoters/`` subdirs, each holding ``<cell-line>.csv`` files (feature
matrix with ``chrom, chromStart, chromEnd, strand`` info columns), one
``*.bed`` (tab-separated; one 0/1 column per cell line) and one ``*.fa``
(alternating sequence and ``>chrom:start-end`` header lines — the reference
treats even lines as sequence and odd ones as header, i.e. sequence first).

The JAX package reads the CSV and BED files with pandas; the port reads them
with the standard ``csv`` module and numpy (pandas is not a dependency of
the port).  Cells that pandas reads as missing (empty, ``NA``, ``NaN``,
``null``, ... : its default ``na_values``) become NaN here too.  Stated
divergence: tables and ``RegionSet.coords`` are dicts of numpy columns
where the JAX package has DataFrames.

Output is array-first: sequences are encoded once to uint8 codes here.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import re

import numpy as np

from embracenet_tpu_torch.data.codec import encode_sequences

INFO_COLUMNS = ("chrom", "chromStart", "chromEnd", "strand")

#: the strings pandas' ``read_csv`` reads as missing by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


@dataclasses.dataclass
class RegionSet:
    """One region family (enhancers or promoters) for all cell lines."""
    features: dict          # cell -> np.ndarray [N, D] float64
    feature_names: dict     # cell -> list[str]
    labels: dict            # cell -> np.ndarray [N] int64
    codes: np.ndarray       # [N, 256] uint8 DNA codes (shared across cells)
    coords: dict            # "chrom"/"chromStart"/"chromEnd" -> [N] str


def _read_table(path: str, delimiter: str) -> tuple[list[str], list[list[str]]]:
    """-> (header, rows of cells); blank lines are skipped, as pandas does."""
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter=delimiter) if r]
    if not rows:
        raise ValueError(f"{path}: no header line")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{path}: line {i + 2} has {len(r)} fields, the "
                             f"header {len(header)}")
    return header, body


def _floats(cells, count: int = -1) -> np.ndarray:
    """Text cells -> float64 (correctly rounded, as Python's ``float``),
    missing cells (:data:`NA_VALUES`) -> NaN."""
    nan = float("nan")
    return np.fromiter((nan if c in NA_VALUES else float(c) for c in cells),
                       np.float64, count)


def _column(cells: list[str]) -> np.ndarray:
    """One text column as pandas would type it: int64 when every cell is
    an integer, float64 (missing -> NaN) when every cell is a number, else
    the strings."""
    try:
        return np.asarray([int(c) for c in cells], np.int64)
    except ValueError:
        pass
    try:
        return _floats(cells)
    except ValueError:
        return np.asarray(cells, dtype=str)


def _coords(headers: list[str]) -> dict:
    parts = [re.split("[>:-]", h)[1:4] for h in headers]
    cols = list(zip(*parts)) if parts else [(), (), ()]
    return {name: np.asarray(col, dtype=str)
            for name, col in zip(("chrom", "chromStart", "chromEnd"), cols)}


def read_fasta(path: str, seq_rng=0, seq_len: int | None = None
               ) -> tuple[np.ndarray, dict]:
    """Parse the reference's .fa layout -> (codes [N, L] uint8, coords).

    Uses the native C++ parser (runtime/ioaccel.cpp) when the sequence
    length is fixed and known and the runtime is available; otherwise the
    Python line parser.
    """
    if seq_len is not None:
        from embracenet_tpu_torch import runtime

        parsed = runtime.parse_fasta_native(path, seq_len=seq_len,
                                            seed=int(seq_rng)
                                            if isinstance(seq_rng, int) else 0)
        if parsed is not None:
            codes, headers = parsed
            return codes, _coords(headers)
    seqs, headers = [], []
    with open(path) as fh:
        for i, line in enumerate(fh):
            (seqs if i % 2 == 0 else headers).append(line.strip())
    return encode_sequences(seqs, seq_rng), _coords(headers)


def read_bed(path: str) -> dict:
    """Tab-separated table -> {column name: numpy column}."""
    header, body = _read_table(path, "\t")
    return {name: _column([r[j] for r in body]) for j, name in enumerate(header)}


def read_features_csv(path: str) -> tuple[np.ndarray, list, dict]:
    """-> (feature matrix float64, feature names, info columns)."""
    header, body = _read_table(path, ",")
    info_idx = [j for j, c in enumerate(header) if c in INFO_COLUMNS]
    feat_idx = [j for j, c in enumerate(header) if c not in INFO_COLUMNS]
    info = {header[j]: _column([r[j] for r in body]) for j in info_idx}
    feats = _floats((r[j] for r in body for j in feat_idx),
                    len(body) * len(feat_idx))
    return (feats.reshape(len(body), len(feat_idx)),
            [header[j] for j in feat_idx], info)


def _cell_name_from_path(path: str) -> str:
    name = os.path.splitext(os.path.basename(path))[0]
    return re.sub("-", "", name).upper()


def load_region_dir(directory: str, seq_rng=0) -> RegionSet:
    """Load one of ``data/enhancers`` / ``data/promoters``."""
    features, names, labels = {}, {}, {}
    codes, coords, bed = None, None, None
    for fname in sorted(os.listdir(directory)):
        path = os.path.join(directory, fname)
        if fname.endswith(".csv"):
            cell = _cell_name_from_path(path)
            features[cell], names[cell], _ = read_features_csv(path)
        elif fname.endswith(".bed"):
            bed = read_bed(path)
        elif fname.endswith(".fa"):
            codes, coords = read_fasta(path, seq_rng)
    if bed is not None:
        for cell in features:
            if cell in bed:
                col = bed[cell]
                if col.dtype.kind not in "iuf" or not np.isfinite(col).all():
                    raise ValueError(f"{directory}: BED column {cell} holds "
                                     "other values than labels")
                labels[cell] = col.astype(np.int64)
    return RegionSet(features=features, feature_names=names, labels=labels,
                     codes=codes, coords=coords)


def load_dataset(root: str = "data", seq_rng=0) -> dict:
    """-> {"enhancers": RegionSet, "promoters": RegionSet}
    (reference ``Load_Create_Task.load``, `dataload.py:78-110`)."""
    return {
        "enhancers": load_region_dir(os.path.join(root, "enhancers"), seq_rng),
        "promoters": load_region_dir(os.path.join(root, "promoters"), seq_rng),
    }
