"""The port's runtime layer (config, distributed bootstrap, checkpoints)
against the JAX package's, on the CPU.

Mirrors tests/learning/test_distributed.py and test_checkpoint.py: the
dtype policy, ``device_info`` and ``process_summary`` with the JAX keys,
``trace`` writing its file, the single-process no-op and the ``PBN_*``
contract of ``initialize``, ``global_mesh``'s axes, a ``save_pytree`` /
``load_pytree`` roundtrip of dtypes, nesting and a generator state,
``nuts_checkpointed`` resumed after a preemption, and ``hc`` resumed from
a model ``SaveModel`` wrote. Multi-process groups are in
tests/test_torch_distributed.py.
"""

import os

import numpy as np
import pytest
import torch

import pybnesian_tpu_torch as tpb
from pybnesian_tpu.runtime import config as jconfig
from pybnesian_tpu.runtime import distributed as jdist
from pybnesian_tpu_torch import runtime as trt
from pybnesian_tpu_torch.runtime import distributed as tdist

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


def test_runtime_exports_the_jax_names():
    import importlib

    import pybnesian_tpu.runtime as jrt

    assert set(jrt.__all__) <= set(trt.__all__)
    assert set(trt.__all__) - set(jrt.__all__) == set(
        trt.device.__all__)
    for name in ("parallel", "runtime.config", "runtime.distributed",
                 "runtime.checkpoint"):
        j, t = (importlib.import_module(f"{pkg}.{name}")
                for pkg in ("pybnesian_tpu", "pybnesian_tpu_torch"))
        assert t.__all__ == j.__all__, name


def test_dtype_policy():
    assert trt.dtype_policy() == np.dtype(np.float32)
    try:
        trt.set_dtype_policy("float64")
        assert trt.dtype_policy() == np.dtype(np.float64)
    finally:
        trt.set_dtype_policy(np.float32)
    assert trt.RuntimeConfig().mesh_axes is None


def test_device_info_has_the_jax_keys():
    info = trt.device_info()
    assert set(info) == set(jconfig.device_info())
    assert info == {"backend": "cpu", "num_devices": 1, "devices": ["cpu"],
                    "process_index": 0, "num_processes": 1}


def test_default_mesh():
    mesh = trt.default_mesh()
    assert mesh.shape == {"data": 1}
    assert list(mesh.devices.flat) == [torch.device("cpu")]


def test_trace_annotates_and_writes_a_file(tmp_path):
    x = torch.ones(4)
    with trt.trace("annotated"):
        x = x + 1
    with trt.trace("profiled", log_dir=str(tmp_path)):
        x = x * 2
    assert float(x.sum()) == 16.0
    path = tmp_path / "profiled.pt.trace.json"
    assert path.is_file() and path.stat().st_size > 0
    assert "profiled" in path.read_text()


def test_initialize_single_process_is_noop():
    assert tdist.initialize() is False
    assert tdist.initialize(num_processes=1) is False
    assert not tdist.is_distributed()


def test_env_var_contract(monkeypatch):
    # PBN_NUM_PROCESSES=1 resolves to the single-process no-op
    monkeypatch.setenv("PBN_NUM_PROCESSES", "1")
    assert tdist.initialize() is False
    # a group asked for without its coordinator, or without an id, raises
    monkeypatch.setenv("PBN_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        tdist.initialize()
    monkeypatch.setenv("PBN_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="process id"):
        tdist.initialize()
    assert not tdist.is_distributed()


def test_process_summary():
    s = tdist.process_summary()
    assert set(s) == set(jdist.process_summary())
    assert s["process_count"] == 1
    assert s["process_index"] == 0
    assert s["global_devices"] == 1
    assert not s["initialized_multiprocess"]


def test_global_mesh_axes():
    mesh = tdist.global_mesh(fam=2, local_devices=["cpu"] * 8)
    assert mesh.shape["fam"] == 2
    assert mesh.shape["data"] * 2 == len(mesh.devices.ravel())
    assert not mesh.spans_processes
    assert tdist.global_mesh().shape == {"data": 1, "fam": 1}
    with pytest.raises(ValueError, match="fam axis must divide"):
        tdist.global_mesh(fam=2)


def test_global_mesh_runs_sharded_kernel():
    from pybnesian_tpu_torch.parallel import sharded_kde_slogl

    mesh = tdist.global_mesh(local_devices=["cpu"] * 4)
    rng = np.random.default_rng(0)
    n = 8 * mesh.shape["data"]
    out = sharded_kde_slogl(
        mesh, torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)), -1.0)
    assert np.isfinite(float(out))


def test_save_load_pytree_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    tree = {
        "a": torch.arange(8, dtype=torch.float32),
        "nested": {"b": torch.ones((3, 2), dtype=torch.float64),
                   "n": 5, "i": torch.tensor([1, 2], dtype=torch.int32)},
        "seq": [np.arange(3, dtype=np.int64), (2.5, np.float32(1.5))],
        "rng": gen.get_state(),
    }
    path = str(tmp_path / "ck")
    trt.save_pytree(path, tree)
    assert os.listdir(path) == ["tree.pt"]
    back = trt.load_pytree(path)
    assert back["a"].dtype == torch.float32
    assert torch.equal(back["a"], torch.arange(8, dtype=torch.float32))
    assert back["nested"]["b"].dtype == torch.float64
    assert back["nested"]["n"] == 5
    assert back["nested"]["i"].dtype == torch.int32
    assert isinstance(back["seq"], list) and isinstance(back["seq"][1], tuple)
    assert torch.equal(back["seq"][0], torch.arange(3))
    assert back["seq"][1][0] == 2.5
    # a generator restored from the checkpoint draws what the original does
    restored = torch.Generator()
    restored.set_state(back["rng"])
    assert torch.equal(torch.rand(4, generator=restored),
                       torch.rand(4, generator=gen))
    # a template restores dtypes (and devices)
    like = trt.load_pytree(path, template=dict(
        tree, a=torch.zeros(8, dtype=torch.float64),
        seq=[np.zeros(3, np.int32), (0.0, np.float32(0))]))
    assert like["a"].dtype == torch.float64
    assert like["seq"][0].dtype == np.int32
    # a second save replaces the first whole
    trt.save_pytree(path, {"a": torch.zeros(2)})
    assert set(trt.load_pytree(path)) == {"a"}
    assert os.listdir(path) == ["tree.pt"]


def test_nuts_checkpointed_resumes(tmp_path):
    """A preempted checkpointed NUTS run continues from the last block and
    produces the same number of samples; posterior mean is sane."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(2.0, 1.0, 500))

    def logp(theta):
        return (-0.5 * torch.sum((x - theta[0]) ** 2)
                - 0.5 * theta[0] ** 2 / 100.0)

    init = torch.zeros(1, dtype=torch.float64)
    ckdir = str(tmp_path / "nuts")

    # "preempted" run: only the warmup block gets written
    samples1, _ = trt.nuts_checkpointed(
        logp, init, 0, ckdir, num_samples=60, block_size=60, num_warmup=100,
        max_depth=5)
    assert samples1.shape[0] == 60

    # resume with a larger target: must reuse the stored state (no warmup)
    samples2, info = trt.nuts_checkpointed(
        logp, init, 0, ckdir, num_samples=180, block_size=60, num_warmup=100,
        max_depth=5)
    assert samples2.shape[0] == 180
    # first block identical to the preempted run's output
    assert torch.equal(samples2[:60], samples1)
    post = float(samples2[60:, 0].mean())
    assert abs(post - float(x.mean())) < 0.2
    assert set(info) == {"step_size", "inv_mass"}
    # stored state survives
    state = trt.load_pytree(os.path.join(ckdir, "state"))
    assert int(state["blocks_done"]) == 3
    assert state["samples"].shape == (180, 1)


def test_hc_resume_from_savemodel(tmp_path):
    """Interrupted hc (max_iters=1) + resume via start=saved model lands on
    the same structure as an uninterrupted run."""
    df = normal_chain_data(600, seed=3)

    full = tpb.hc(df, bn_type=tpb.GaussianNetworkType(), seed=0)

    folder = str(tmp_path / "iters")
    os.makedirs(folder, exist_ok=True)
    partial = tpb.hc(df, bn_type=tpb.GaussianNetworkType(), seed=0,
                     max_iters=1, callback=tpb.SaveModel(folder))
    saved = sorted(os.listdir(folder))
    assert saved, "SaveModel wrote nothing"
    restored = tpb.load(os.path.join(folder, saved[-1]))
    assert restored.num_arcs() == partial.num_arcs()
    resumed = tpb.hc(df, bn_type=tpb.GaussianNetworkType(), seed=0,
                     start=restored)
    assert set(resumed.arcs()) == set(full.arcs())
