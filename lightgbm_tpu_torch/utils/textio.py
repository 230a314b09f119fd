"""Text data file loading: CSV / TSV / LibSVM with auto-detection.

A copy of lightgbm_tpu/utils/textio.py (the port imports nothing of the
JAX package) with its Python parse paths only: the JAX package's native
parser is its own, and its fallback here gives the same float64 arrays.
Re-implements the reference parser + loader semantics
(src/io/parser.cpp CreateParser auto-detect, src/io/dataset_loader.cpp
LoadFromFile / SetHeader label/weight/group/ignore column handling).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["load_text_file", "parse_column_spec", "LoadedFile"]


class LoadedFile:
    def __init__(self, X, label, weight, group, feature_names):
        self.X = X
        self.label = label
        self.weight = weight
        self.group = group
        self.feature_names = feature_names


def parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """Resolve a column spec: an index, or ``name:<column_name>``
    (reference: dataset_loader.cpp SetHeader:70-180). Returns -1 if unset."""
    if spec is None or spec == "":
        return -1
    spec = str(spec)
    if spec.startswith("name:"):
        name = spec[5:]
        if not header_names:
            raise ValueError(
                f"Cannot resolve column 'name:{name}' without a header")
        if name not in header_names:
            raise ValueError(f"Column '{name}' not found in header")
        return header_names.index(name)
    return int(spec)


def _parse_ignore_spec(spec: str, header_names) -> List[int]:
    if not spec:
        return []
    spec = str(spec)
    if spec.startswith("name:"):
        names = spec[5:].split(",")
        if not header_names:
            raise ValueError("ignore_column by name requires a header")
        return [header_names.index(n) for n in names if n in header_names]
    return [int(x) for x in spec.split(",") if x.strip() != ""]


def _detect_format(sample_lines: List[str]) -> Tuple[str, str]:
    """Returns (kind, sep) with kind in {'libsvm','delim'}.
    reference: parser.cpp GetDelimiter/DetermineDataType."""
    for line in sample_lines:
        toks = line.split()
        if any(":" in t for t in toks[1:]):
            # index:value pairs after the label → LibSVM
            if all(":" in t for t in toks[1:] if t):
                return "libsvm", " "
    line = sample_lines[0]
    for sep in ("\t", ",", " ", ";"):
        if sep in line:
            return "delim", sep
    return "delim", ","


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def load_text_file(path: str, *, has_header: bool = False,
                   label_column: str = "", weight_column: str = "",
                   group_column: str = "", ignore_column: str = "",
                   max_rows: Optional[int] = None) -> LoadedFile:
    """Load a CSV/TSV/LibSVM file into a dense matrix + metadata columns
    (the file is read once as bytes)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    # decode only a small probe for header/format detection
    probe_text = raw[:65536].decode("utf-8", errors="replace")
    probe_lines = [ln for ln in probe_text.split("\n") if ln.strip() != ""]
    if not probe_lines:
        raise ValueError(f"Empty data file: {path}")

    header_names: Optional[List[str]] = None
    data_start = 0
    first_line = probe_lines[0]
    probe = first_line.replace(",", " ").replace("\t", " ").split()
    header_detected = has_header or not all(
        _is_number(t) or ":" in t for t in probe)
    if header_detected:
        sep0 = "\t" if "\t" in first_line else \
            ("," if "," in first_line else " ")
        header_names = [c.strip() for c in first_line.split(sep0)]
        nl = raw.find(b"\n")
        data_start = nl + 1 if nl >= 0 else len(raw)
    kind, sep = _detect_format(
        probe_lines[1:101] if header_detected else probe_lines[:100])

    label_idx = parse_column_spec(label_column, header_names)
    if label_idx < 0:
        label_idx = 0  # reference default: first column is the label
    weight_idx = parse_column_spec(weight_column, header_names)
    group_idx = parse_column_spec(group_column, header_names)
    ignore = set(_parse_ignore_spec(ignore_column, header_names))

    data = raw[data_start:]
    if max_rows is not None:
        # keep only the first max_rows non-empty lines
        kept, cnt, pos = [], 0, 0
        while cnt < max_rows and pos < len(data):
            nl = data.find(b"\n", pos)
            end = nl if nl >= 0 else len(data)
            if data[pos:end].strip():
                cnt += 1
            pos = end + 1 if nl >= 0 else len(data)
        data = data[:pos]

    if kind == "libsvm":
        return _load_libsvm(data, weight_idx, group_idx)

    data_lines = [ln for ln in data.decode("utf-8", errors="replace")
                  .split("\n") if ln.strip() != ""]
    rows = [ln.split(sep) for ln in data_lines]
    ncol = max(len(r) for r in rows)
    mat = np.full((len(rows), ncol), np.nan, dtype=np.float64)
    for i, r in enumerate(rows):
        for j, tok in enumerate(r):
            tok = tok.strip()
            if tok == "" or tok.lower() in ("na", "nan", "null", "none"):
                continue
            try:
                mat[i, j] = float(tok)
            except ValueError:
                mat[i, j] = np.nan
    ncol = mat.shape[1]

    label = mat[:, label_idx].copy()
    weight = mat[:, weight_idx].copy() if weight_idx >= 0 else None
    group_col = mat[:, group_idx].copy() if group_idx >= 0 else None

    meta_cols = {label_idx} | ignore
    if weight_idx >= 0:
        meta_cols.add(weight_idx)
    if group_idx >= 0:
        meta_cols.add(group_idx)
    feat_cols = [j for j in range(ncol) if j not in meta_cols]
    X = mat[:, feat_cols]
    feature_names = None
    if header_names:
        feature_names = [header_names[j] for j in feat_cols]

    group = None
    if group_col is not None:
        # group column holds a query id per row → convert to group sizes
        # (reference: metadata.cpp SetQueryId)
        ids = group_col
        boundaries = [0]
        for i in range(1, len(ids)):
            if ids[i] != ids[i - 1]:
                boundaries.append(i)
        boundaries.append(len(ids))
        group = np.diff(boundaries).astype(np.int32)

    return LoadedFile(X, label, weight, group, feature_names)


def _qids_to_group(qids: np.ndarray) -> Optional[np.ndarray]:
    """Consecutive qid runs -> group sizes (reference: Metadata::SetQueryId)."""
    if qids is None or np.isnan(qids).all():
        return None
    boundaries = [0]
    for i in range(1, len(qids)):
        if qids[i] != qids[i - 1]:
            boundaries.append(i)
    boundaries.append(len(qids))
    return np.diff(boundaries).astype(np.int32)


def _load_libsvm(data, weight_idx: int, group_idx: int) -> LoadedFile:
    data_lines = [ln for ln in data.decode("utf-8", errors="replace")
                  .split("\n") if ln.strip() != ""]
    labels = np.empty(len(data_lines), dtype=np.float64)
    qids = np.full(len(data_lines), np.nan)
    entries: List[List[Tuple[int, float]]] = []
    max_feat = -1
    for i, ln in enumerate(data_lines):
        toks = ln.split()
        labels[i] = float(toks[0])
        row = []
        for t in toks[1:]:
            if ":" not in t:
                continue
            k, v = t.split(":", 1)
            if k == "qid":
                qids[i] = float(v)
                continue
            try:
                j = int(k)
            except ValueError:   # malformed key: skip, like the native path
                continue
            row.append((j, float(v)))
            max_feat = max(max_feat, j)
        entries.append(row)
    X = np.zeros((len(data_lines), max_feat + 1), dtype=np.float64)
    for i, row in enumerate(entries):
        for j, v in row:
            X[i, j] = v
    return LoadedFile(X, labels, None, _qids_to_group(qids), None)
