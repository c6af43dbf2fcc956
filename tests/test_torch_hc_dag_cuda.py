"""A CV batch of CKDE families of widths 2 to 9, the widths a search over
a few dozen nodes reaches (``spbn46.learn``: 1 to 9 at 10,000 rows), on
the card: each family's float32 score is the same bits alone, in the
mixed batch padded to width 9, and in the batch permuted, so a family
takes one number whatever its call. The CPU's plain route does not
promise this across padded widths (its pair distances are float32
matmuls as wide as the batch).

Needs an NVIDIA GPU and skips without one; imports neither JAX nor the
JAX package:

    python -m pytest --noconftest tests/test_torch_hc_dag_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

import pybnesian_tpu_torch as pt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_dag import dag_data, dag_families  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [500, 10_000])
def test_a_family_alone_has_its_bits_in_a_mixed_width_batch(cuda, rows):
    df = dag_data(12, 16, rows, 3, "float32")
    score = pt.CVLikelihood(df, 10, 3, device=cuda)
    model = pt.KDENetwork(list(df.columns))
    fams = [(v, ps, pt.CKDEType()) for v, ps in dag_families(range(2, 10))]
    batch = score.local_score_batch(model, fams)
    alone = np.array([score.local_score_batch(model, [f])[0] for f in fams])
    permuted = score.local_score_batch(model, fams[::-1])[::-1]
    assert np.isfinite(batch).all()
    np.testing.assert_array_equal(alone, batch)
    np.testing.assert_array_equal(permuted, batch)
