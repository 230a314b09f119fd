"""The port's text loader (``lightgbm_tpu_torch/utils/textio.py``, the
Python parse paths) against the JAX package's (``lightgbm_tpu/utils/
textio.py``, whose native parser serves the delimited files where it
builds): the same float64 matrices bit for bit (NaN where the other has
NaN), the same labels, weights, query groups and feature names, on the
examples' files and on small files with a header, named columns, a
weight column, ignored columns, missing tokens and LibSVM rows.
"""

import os

import numpy as np
import pytest

from lightgbm_tpu.utils import textio as jtext
from lightgbm_tpu_torch.utils import textio as ttext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["binary_classification/binary.train",
            "binary_classification/binary.test",
            "regression/regression.train", "regression/regression.test"]


def _same_f64(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.uint64),
                                  b[~nan].view(np.uint64))


def _same(ja, ta):
    _same_f64(ja.X, ta.X)
    _same_f64(ja.label, ta.label)
    _same_f64(ja.weight, ta.weight)
    if ja.group is None:
        assert ta.group is None
    else:
        np.testing.assert_array_equal(ja.group, ta.group)
    assert ja.feature_names == ta.feature_names


@pytest.mark.parametrize("rel", EXAMPLES)
def test_examples_load_bit_identical(rel):
    path = os.path.join(ROOT, "examples", rel)
    ta = ttext.load_text_file(path)
    _same(jtext.load_text_file(path), ta)
    assert ta.X.shape[0] > 400 and ta.X.shape[1] >= 10


CSV = ("id,f0,target,w,f1,note,f2\n"
       "1,0.5,1,2.0,-1e-3,7,3.25\n"
       "2,,0,1.5,NA,8,1e10\n"
       "3,-0.1,1,0.25,nan,9,-0.0\n"
       "4,1.7976931348623157e308,0,1,2.2250738585072014e-308,10,0.1\n")


@pytest.mark.parametrize("kw", [
    dict(label_column="name:target", weight_column="name:w",
         ignore_column="name:id,note"),
    dict(label_column="2", weight_column="3", ignore_column="0,5"),
    dict(label_column="name:target", group_column="name:note"),
])
def test_csv_with_header_and_named_columns(tmp_path, kw):
    path = tmp_path / "d.csv"
    path.write_text(CSV)
    ta = ttext.load_text_file(str(path), has_header=True, **kw)
    _same(jtext.load_text_file(str(path), has_header=True, **kw), ta)
    assert ta.label.tolist() == [1.0, 0.0, 1.0, 0.0]
    if "weight_column" in kw:
        assert ta.weight.tolist() == [2.0, 1.5, 0.25, 1.0]
        assert ta.feature_names == ["f0", "f1", "f2"]


def test_tsv_without_header_and_max_rows(tmp_path):
    rows = ["\t".join(f"{v:.17g}" for v in r) for r in
            np.random.RandomState(3).normal(size=(50, 6))]
    path = tmp_path / "d.tsv"
    path.write_text("\n".join(rows) + "\n\n")
    _same(jtext.load_text_file(str(path)), ttext.load_text_file(str(path)))
    _same(jtext.load_text_file(str(path), max_rows=7),
          ttext.load_text_file(str(path), max_rows=7))
    assert ttext.load_text_file(str(path), max_rows=7).X.shape == (7, 5)


def test_libsvm_with_query_ids(tmp_path):
    path = tmp_path / "d.svm"
    path.write_text("1 qid:1 0:0.5 3:-2\n0 qid:1 2:1e-7\n"
                    "1 qid:2 1:3 3:4.5\n0 qid:3 0:-1\n")
    ta = ttext.load_text_file(str(path))
    _same(jtext.load_text_file(str(path)), ta)
    assert ta.X.shape == (4, 4) and ta.group.tolist() == [2, 1, 1]


def test_column_spec_errors():
    with pytest.raises(ValueError, match="header"):
        ttext.parse_column_spec("name:x", None)
    with pytest.raises(ValueError, match="not found"):
        ttext.parse_column_spec("name:x", ["a", "b"])
    assert ttext.parse_column_spec("", None) == -1
