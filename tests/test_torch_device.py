"""The port's device rule: the card is the default, the CPU only when asked.

With no GPU visible (``torch.cuda.is_available`` patched to False, as on a
machine without a card) and no device chosen, every entry point raises;
with the CPU chosen — by ``device=`` or by ``use_device`` — it runs. These
tests make their own choice, so they carry no autouse CPU fixture.
"""

import numpy as np
import pytest
import torch

import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch.runtime import device as rt


def _cols(n=120, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n)
    return {"x": x, "y": np.sin(x) + rng.normal(0, 0.3, n)}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pt.use_device(None):  # no choice made, whatever came before
        yield


def test_default_device_raises_without_a_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="use_device"):
        rt.default_device()


@pytest.mark.parametrize("entry", [
    lambda df: pt.CVLikelihood(df, k=3),
    lambda df: pt.HoldoutLikelihood(df),
    lambda df: pt.ValidatedLikelihood(df, k=3),
    lambda df: pt.BIC(df),
    lambda df: pt.hc(df, bn_type=pt.SemiparametricBNType()),
    lambda df: pt.DataFrame.wrap(df).device_matrix(["x"]),
])
def test_entry_points_raise_without_a_choice(no_gpu, entry):
    with pytest.raises(RuntimeError, match="none is visible"):
        entry(_cols())


def test_cvlikelihood_raises_then_scores_on_the_chosen_cpu(no_gpu):
    cols = _cols()
    with pytest.raises(RuntimeError):
        pt.CVLikelihood(cols, k=3)
    model = pt.SemiparametricBN(["x", "y"])
    fams = [("y", ["x"], pt.CKDEType()), ("y", ["x"], pt.LinearGaussianCPDType())]
    with pt.use_device("cpu"):
        score = pt.CVLikelihood(cols, k=3)
        assert score.device.type == "cpu"
        got = score.local_score_batch(model, fams)
    want = pt.CVLikelihood(cols, k=3, device="cpu").local_score_batch(model,
                                                                      fams)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, want)


def test_fitted_factors_follow_the_choice(no_gpu):
    df = pt.DataFrame.wrap(_cols())
    cpd = pt.CKDE("y", ["x"])
    cpd.fit(df)
    with pytest.raises(RuntimeError):
        cpd.logl(df)
    with pt.use_device("cpu"):
        assert np.all(np.isfinite(cpd.logl(df)))


def test_use_device_as_a_call_and_as_a_context(no_gpu):
    with pt.use_device("cpu") as chosen:
        assert chosen == torch.device("cpu")
        assert rt.default_device() == torch.device("cpu")
        with pt.use_device("meta"):
            assert rt.default_device() == torch.device("meta")
        assert rt.default_device() == torch.device("cpu")
    with pytest.raises(RuntimeError):
        rt.default_device()
    choice = pt.use_device("cpu")
    try:
        assert rt.default_device() == torch.device("cpu")
    finally:
        choice.__exit__(None, None, None)
    with pytest.raises(RuntimeError):
        rt.default_device()


def test_scores_take_their_device_into_the_factor_routes(no_gpu):
    """A score made with device='cpu' fits its factors on the CPU too
    (the validation update of hc), with no process-wide choice."""
    cols = _cols()
    score = pt.ValidatedLikelihood(cols, k=3, device="cpu")
    model = pt.SemiparametricBN(["x", "y"], [("x", "y")],
                                [("y", pt.CKDEType())])
    assert np.isfinite(score.vlocal_score(model, "y"))
    learned = pt.hc(cols, bn_type=pt.SemiparametricBNType(), score=score,
                    max_iters=2)
    assert learned.num_nodes() == 2


def _mixed(n=150, seed=0):
    import pandas as pd

    rng = np.random.default_rng(seed)
    a = pd.Categorical(rng.choice(["u", "v"], n))
    x = rng.normal(np.asarray(a.codes), 1.0, n)
    return pd.DataFrame({"a": a, "x": x, "y": x + rng.normal(0, 0.5, n)})


def test_hckde_logl_raises_without_a_choice(no_gpu):
    df = _mixed()
    cpd = pt.HCKDE("y", ["x", "a"])
    cpd.fit(df)
    with pytest.raises(RuntimeError, match="none is visible"):
        cpd.logl(df)
    with pt.use_device("cpu"):
        assert np.all(np.isfinite(cpd.logl(df)))


def test_dynamic_logl_raises_without_a_choice(no_gpu):
    cols = _cols()
    dbn = pt.DynamicSemiparametricBN(["x", "y"], 1)
    dbn.transition_bn().set_node_type("y_t_0", pt.CKDEType())
    dbn.transition_bn().add_arc("x_t_1", "y_t_0")
    dbn.fit(cols)
    with pytest.raises(RuntimeError, match="none is visible"):
        dbn.logl(cols)
    with pt.use_device("cpu"):
        assert np.all(np.isfinite(dbn.logl(cols)))


@pytest.mark.parametrize("entry", [
    lambda df: pt.hc(df, bn_type=pt.CLGNetworkType(), score="validated-lik"),
    lambda df: pt.MMHC().estimate(pt.MutualInformation(df),
                                  bn_type=pt.SemiparametricBNType(),
                                  score="validated-lik"),
    lambda df: pt.DMMHC().estimate(
        pt.DynamicLinearCorrelation(pt.DynamicDataFrame(df[["x", "y"]], 1)),
        bn_type=pt.GaussianNetworkType(), markovian_order=1),
])
def test_score_based_learners_raise_without_a_choice(no_gpu, entry):
    with pytest.raises(RuntimeError, match="none is visible"):
        entry(_mixed())


def test_constraint_searches_stay_on_the_host(no_gpu):
    """PC and MMPC over the host tests hold no tensor, as in the JAX
    package: they need no device choice."""
    df = _mixed(300)
    pdag = pt.PC().estimate(pt.MutualInformation(df), alpha=0.05)
    assert pdag.num_nodes() == 3
    assert pt.MMPC().estimate(pt.MutualInformation(df)).num_nodes() == 3
