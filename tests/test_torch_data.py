"""The port's data classes of the utility experiments against the JAX
package: `ByteCorpus` and `SyntheticClassification`
(`repro.data.pipeline`), numpy on both sides, so the same inputs must
give bitwise-equal arrays (no tolerance).
"""
import numpy as np
import pytest

from repro.data import pipeline as JPIPE
from repro_torch import data
from repro_torch.data import pipeline as PIPE

# a multi-byte character (3 and 4 bytes in UTF-8), empty documents between
# separators and at both ends, a lone surrogate that UTF-8 cannot encode
# ("ignore" drops it), and a custom separator
TEXTS = [("\n\nhello wörld\n\n\n\nsecond — doc 🙂\n\n", "\n\n"),
         ("a||||b\ud800c||", "||"), ("", "\n\n"), ("\n\n\n\n", "\n\n")]


@pytest.mark.parametrize("text,sep", TEXTS)
def test_byte_corpus_matches_reference(text, sep):
    got = PIPE.ByteCorpus(text, doc_sep=sep)
    want = JPIPE.ByteCorpus(text, doc_sep=sep)
    assert got.vocab_size == want.vocab_size == 257
    gd, wd = got.documents(), want.documents()
    assert len(gd) == len(wd)
    for a, b in zip(gd, wd):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if text.startswith("\n\nhello"):
        # empty documents are skipped; ö is 2 bytes, — 3, 🙂 4
        assert len(gd) == 2 and gd[0].size == len("hello wörld") + 1
        assert gd[1].size == len("second  doc ") + 3 + 4


@pytest.mark.parametrize("kw", [{}, {"seed": 7}, {
    "num_classes": 3, "dim": 5, "num_examples": 17, "noise": 0.1,
    "seed": 2}])
def test_synthetic_classification_matches_reference(kw):
    x, y = PIPE.SyntheticClassification(**kw).arrays()
    jx, jy = JPIPE.SyntheticClassification(**kw).arrays()
    assert x.dtype == jx.dtype == np.float32
    assert y.dtype == jy.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert data.SyntheticClassification is PIPE.SyntheticClassification
    assert data.ByteCorpus is PIPE.ByteCorpus
