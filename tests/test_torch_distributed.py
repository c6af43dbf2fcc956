"""The port's sharded functions across a two-process ``torch.distributed``
group (gloo, on the CPU).

Two spawned processes each start the group through
``runtime.distributed.initialize`` and build ``global_mesh`` over a local
mesh of two virtual CPU shards, so ``data`` (4 shards) spans both
processes and every sum and gather crosses them. Each process's
``sharded_batched_bic``, ``sharded_lg_fit``, ``sharded_kde_slogl``,
``sharded_ckde_cv`` and NUTS ``sample_chains_sharded`` results must equal
those of one process's 4-shard mesh (float64; 1e-12 relative, the sums
over ``data`` added in another order), on a (4, 1) and a (2, 2) mesh.

This file imports no JAX: the spawned children import it to find their
target. The group gets a free port at run time, each process joins within
a time limit, and a hung child is killed, so a hang fails one test.
"""

import multiprocessing
import queue
import socket

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch import parallel
from pybnesian_tpu_torch.inference import sample_chains_sharded
from pybnesian_tpu_torch.runtime import distributed
from pybnesian_tpu_torch.runtime.device import use_device

from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

WORLD = 2
JOIN_S = 120
RTOL = 1e-12


def _inputs():
    rng = np.random.default_rng(0)
    n, D, F = 64, 4, 4
    values = rng.normal(size=(n, D)) @ rng.normal(size=(D, D))
    valid = (rng.random((n, D)) > 0.1).astype(np.float64)
    var_idx = np.arange(F) % D
    parent_idx = np.stack([(np.arange(F) + 1) % D, (np.arange(F) + 2) % D], 1)
    parent_mask = np.ones((F, 2))
    parent_mask[0] = 0.0
    train = rng.normal(0, 2, (32, 2))
    test = rng.normal(0, 2, (8, 2))
    K, ntr, nte = 2, 48, 16
    cv = (rng.normal(size=(n, D)), np.zeros((n, D)),
          np.stack([[0, 0], [1, 2], [3, 0], [0, 3]]),
          np.array([[1.0, 0.0], [1, 1], [1, 0], [1, 1]]),
          np.stack([np.arange(ntr), np.arange(n - ntr, n)]), np.ones((K, ntr)),
          np.stack([np.arange(n - nte, n), np.arange(nte)]), np.ones((K, nte)))
    t = torch.from_numpy
    return ((t(values), t(valid), t(var_idx), t(parent_idx), t(parent_mask)),
            (t(train), t(test)), tuple(map(t, cv)))


def _logdensity(theta):
    return -0.5 * torch.sum(torch.square(theta - 1.0))


def _results(mesh):
    """Every sharded function's result on ``mesh``, as numpy."""
    fam_args, (train, test), cv = _inputs()
    beta, var = parallel.sharded_lg_fit(mesh, *fam_args)
    chains, _ = sample_chains_sharded(
        _logdensity, torch.zeros(2, dtype=torch.float64), 5, mesh,
        chains_per_device=1, method="nuts", num_samples=3, num_warmup=3,
        max_depth=3)
    out = {"beta": beta, "variance": var,
           "bic": parallel.sharded_batched_bic(mesh, *fam_args),
           "slogl": parallel.sharded_kde_slogl(mesh, train, test, -1.0),
           "ckde_cv": parallel.sharded_ckde_cv(mesh, *cv),
           "chains": chains}
    return {k: v.numpy() for k, v in out.items()}


def _child(rank, port, results):
    """One process of the group: start it, run every sharded function on
    the global meshes, send the results (or the error) to the parent."""
    torch.set_num_threads(1)
    use_device("cpu")
    try:
        assert distributed.initialize(f"127.0.0.1:{port}", WORLD, rank)
        assert distributed.is_distributed()
        out = {"summary": distributed.process_summary()}
        for fam in (1, 2):
            mesh = distributed.global_mesh(fam=fam,
                                           local_devices=["cpu"] * 2)
            out[fam] = (mesh.shape, mesh.processes.tolist(), _results(mesh))
        results.put((rank, out))
    except Exception as exc:  # reported to the parent, which fails the test
        results.put((rank, repr(exc)))
    finally:
        distributed.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group_results():
    """Both processes' results, by rank."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(rank, port, results))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=JOIN_S)
            got[rank] = out
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(WORLD):
        assert isinstance(got.get(rank), dict), f"rank {rank}: {got.get(rank)}"
    assert not any(p.is_alive() for p in procs)
    return got


def test_group_summary(group_results):
    for rank, out in group_results.items():
        s = out["summary"]
        assert s["process_index"] == rank and s["process_count"] == WORLD
        assert s["initialized_multiprocess"]
        assert s["local_devices"] == ["cpu"]
        assert s["global_devices"] == WORLD


@pytest.mark.parametrize("fam", [1, 2])
def test_two_processes_equal_one(group_results, fam):
    local = parallel.make_mesh({"data": 4 // fam, "fam": fam},
                               devices=["cpu"] * 4)
    want = _results(local)
    for rank, out in group_results.items():
        shape, owners, got = out[fam]
        assert shape == {"data": 4 // fam, "fam": fam}
        # data spans the processes: rank 0 holds the first half of the mesh
        assert sorted(sum(owners, [])) == [0, 0, 1, 1]
        assert owners[0][0] == 0 and owners[-1][-1] == 1
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=RTOL, atol=0,
                                       err_msg=f"rank {rank}: {key}")
