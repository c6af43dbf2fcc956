"""Multi-device layer of the torch port: a mesh of devices and the four
sharded functions of ``pybnesian_tpu/parallel``.

A :class:`Mesh` is a grid of torch devices with named axes, ``data`` and
``fam`` here: rows (or training points) are split over ``data``, candidate
families over ``fam``. JAX runs one program per device under
``shard_map`` and combines them with XLA collectives. Here each sharded
function issues every shard's work on its own device, reading no result
inside the shard loop, so that shards on different cards overlap; then it
combines the shards through one of two helpers, the only collectives of
the layer:

- :func:`psum_data`, the sum over ``data`` (JAX's single ``psum``);
- :func:`all_gather_data`, the gather over ``data`` (JAX's
  ``all_gather``).

In one process both combine on the mesh's first device. A mesh built by
:func:`pybnesian_tpu_torch.runtime.distributed.global_mesh` spans the
processes of a ``torch.distributed`` group: each process computes the
shards on its own devices, and the helpers then all-reduce or all-gather
across the group, so that every process returns the whole result, as every
JAX process holds the global array. Every process calls with the same
arguments.

A device may repeat in a mesh when the caller lists it so (virtual shards,
the counterpart of the JAX tests' eight virtual CPU devices); its shards
then run one after another. Shapes must divide their axes (rows the
``data`` axis, families the ``fam`` axis): the functions raise rather than
pad, as the JAX package asks its callers to pad.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kde as kde_ops
from ..ops.gaussian import bic_from_gram, family_grams, lg_params_from_gram
from ..runtime.device import visible_devices
from ..runtime.distributed import rank_and_size

__all__ = [
    "make_mesh",
    "data_fam_mesh",
    "sharded_batched_bic",
    "sharded_lg_fit",
    "sharded_kde_slogl",
    "sharded_ckde_cv",
]


def _object_array(items, shape):
    """``items`` as a numpy object array of ``shape`` (numpy would try to
    read a sequence of devices as nested data)."""
    arr = np.empty(len(items), dtype=object)
    arr[:] = items
    return arr.reshape(shape)


class Mesh:
    """A grid of devices with named axes.

    ``devices``: numpy object array of ``torch.device``, one array axis per
    name of ``axis_names``; ``shape``: axis name -> size, as JAX's
    ``mesh.shape["data"]``; ``processes``: an int array of the same shape,
    the rank of the process that owns each device (this process's for a
    mesh that :func:`make_mesh` built)."""

    def __init__(self, devices, axis_names, processes=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.processes = (np.full(devices.shape, rank_and_size()[0])
                          if processes is None
                          else np.asarray(processes).reshape(devices.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self) -> torch.device:
        """The mesh's first device of this process: where results land."""
        mine = self.devices[self.processes == rank_and_size()[0]]
        if mine.size == 0:
            raise ValueError("the mesh holds no device of this process")
        return mine.flat[0]

    @property
    def spans_processes(self) -> bool:
        return len(np.unique(self.processes)) > 1

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Mesh over the given devices (default: every visible card, or the
    CPU under ``use_device("cpu")``), e.g. ``make_mesh({"data": 4, "fam":
    2})``. Raises ``ValueError`` when the mesh needs more devices than
    there are. A device repeats only where ``devices`` repeats it."""
    devices = list(devices) if devices is not None else visible_devices()
    names = tuple(axis_sizes.keys())
    shape = tuple(axis_sizes.values())
    total = int(np.prod(shape))
    if total > len(devices):
        raise ValueError(
            f"Mesh of {total} devices requested but only {len(devices)} "
            "available"
        )
    return Mesh(_object_array([torch.device(d) for d in devices[:total]],
                              shape), names)


def data_fam_mesh(n_devices: int | None = None, fam: int = 1,
                  devices=None) -> Mesh:
    """2-D (data, fam) mesh over ``n_devices`` of ``devices`` (default:
    all of :func:`make_mesh`'s default devices)."""
    devices = list(devices) if devices is not None else visible_devices()
    n = n_devices if n_devices is not None else len(devices)
    if n % fam != 0:
        raise ValueError("fam axis must divide the device count")
    return make_mesh({"data": n // fam, "fam": fam}, devices)


# ------------------------------------------------------------- the layout
def _grid(mesh):
    """The mesh as (data, fam) arrays of devices and of their owning
    ranks. An axis the mesh lacks has size 1; along any other axis the
    work is replicated, and its first device computes."""
    keep = [n for n in mesh.axis_names if n in ("data", "fam")]
    index = tuple(slice(None) if n in ("data", "fam") else 0
                  for n in mesh.axis_names)
    devices, processes = mesh.devices[index], mesh.processes[index]
    for name in ("data", "fam"):
        if name not in keep:
            devices, processes = devices[..., None], processes[..., None]
            keep.append(name)
    order = [keep.index("data"), keep.index("fam")]
    return devices.transpose(order), processes.transpose(order)


def local_shards(mesh, axis: str):
    """[(shard index, device)] of this process along ``axis``: for each
    index along the axis that this process holds a device of, the first
    such device (the work of a shard replicates along the other axes). A
    mesh without ``axis`` is one shard."""
    if axis not in mesh.axis_names:
        return [(0, mesh.home)]
    a = mesh.axis_names.index(axis)
    size = mesh.devices.shape[a]
    devices = np.moveaxis(mesh.devices, a, 0).reshape(size, -1)
    mine = np.moveaxis(mesh.processes, a, 0).reshape(size, -1) == (
        rank_and_size()[0])
    return [(s, devices[s][mine[s]][0]) for s in range(size)
            if mine[s].any()]


def _divides(count, size, what, axis):
    if count % size:
        raise ValueError(f"{count} {what} do not divide the '{axis}' axis "
                         f"of {size}; pad them to a multiple")
    return count // size


# ---------------------------------------------------------- the collectives
def psum_data(mesh, blocks, fam_size):
    """The sum over ``data`` of this process's per-shard blocks:
    ``blocks`` is a list of (fam shard j, tensor (rows_j, ...)) with every
    tensor of one shape; returns the (fam_size · rows_j, ...) sums on the
    mesh's home device, fam shards in order. When the mesh spans the
    processes of a group, the local sums are then all-reduced across it,
    so every process gets the whole sum (one collective, as JAX's one
    ``psum`` of the Grams and counts together)."""
    home = mesh.home
    first = blocks[0][1]
    total = torch.zeros((fam_size,) + tuple(first.shape), dtype=first.dtype,
                        device=home)
    for j, block in blocks:
        total[j] += block.to(home)
    if mesh.spans_processes:
        torch.distributed.all_reduce(total)
    return total.reshape((-1,) + tuple(first.shape[1:]))


def all_gather_data(mesh, parts):
    """This process's per-shard tensors (one shape, in shard order)
    stacked on the mesh's home device: (shards, ...). When the mesh spans
    the processes of a group, every process's stack is all-gathered across
    it in rank order (each process holding as many shards)."""
    home = mesh.home
    local = torch.stack([p.to(home) for p in parts])
    if not mesh.spans_processes:
        return local
    gathered = [torch.empty_like(local)
                for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(gathered, local)
    return torch.cat(gathered)


# ------------------------------------------------------ the sharded functions
def _sharded_grams(mesh, values, valid, var_idx, parent_idx, parent_mask):
    """(grams (F, P+2, P+2), n_eff (F,), parent_mask) on the home device:
    each (data, fam) shard's Grams of its rows and families by
    :func:`family_grams`, summed over ``data`` by :func:`psum_data`."""
    values, valid, var_idx, parent_idx, parent_mask = (
        torch.as_tensor(t) for t in (values, valid, var_idx, parent_idx,
                                     parent_mask))
    devices, processes = _grid(mesh)
    n_data, n_fam = devices.shape
    rows = _divides(values.shape[0], n_data, "rows", "data")
    fams = _divides(var_idx.shape[0], n_fam, "families", "fam")
    rank = rank_and_size()[0]
    blocks = []
    for j in range(n_fam):
        fs = slice(j * fams, (j + 1) * fams)
        for i in range(n_data):
            if processes[i, j] != rank:
                continue
            d = devices[i, j]
            rs = slice(i * rows, (i + 1) * rows)
            gram, n_eff = family_grams(
                values[rs].to(d), valid[rs].to(d),
                var_idx[fs].to(d, torch.long),
                parent_idx[fs].to(d, torch.long), parent_mask[fs].to(d))
            blocks.append((j, torch.cat([gram.flatten(1), n_eff[:, None]],
                                        dim=1)))
    total = psum_data(mesh, blocks, n_fam)
    width = parent_idx.shape[1] + 2
    grams = total[:, :-1].reshape(-1, width, width)
    return grams, total[:, -1], parent_mask.to(mesh.home)


def sharded_batched_bic(mesh: Mesh, values, valid, var_idx, parent_idx,
                        parent_mask):
    """(F,) BIC local scores with rows split over ``data`` and families
    over ``fam``: each shard's Grams (:func:`family_grams`), one sum over
    ``data``, then the per-family solves (:func:`bic_from_gram`) on the
    mesh's home device. Rows must divide ``data``, families ``fam``."""
    grams, n_eff, pm = _sharded_grams(mesh, values, valid, var_idx,
                                      parent_idx, parent_mask)
    return bic_from_gram(grams, pm, n_eff)


def sharded_lg_fit(mesh: Mesh, values, valid, var_idx, parent_idx,
                   parent_mask):
    """Every family's LinearGaussian MLE on the mesh, ``(betas (F, P+1),
    variances (F,))``: the Grams as in :func:`sharded_batched_bic`, then
    :func:`lg_params_from_gram` per family."""
    grams, n_eff, pm = _sharded_grams(mesh, values, valid, var_idx,
                                      parent_idx, parent_mask)
    beta, variance, _ = lg_params_from_gram(grams, pm, n_eff)
    return beta, variance


def sharded_ckde_cv(mesh: Mesh, data, null_mask, col_idx, col_mask, tr_idx,
                    tr_mask, te_idx, te_mask, chunk: int = 256,
                    rule: str = "nr"):
    """(F,) CV log-likelihoods of F CKDE families split over ``fam``: data
    and folds replicate, and each fam shard scores its families on its
    device by the port's routing rule (:func:`kernel_route`): a float32
    CUDA shard runs :func:`ckde_cv_alldevice_flash` (the CV pairs kernel),
    any other :func:`ckde_cv_alldevice`. Arguments as
    :func:`ckde_cv_alldevice`'s; F must divide ``fam``. ``chunk`` is kept
    for the JAX signature and unused: the kernel and the plain form size
    their own test chunks. The ``fam`` axis carries no collective; on a
    mesh that spans processes, every process scores every fam shard on its
    own device of that shard's column."""
    data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask = (
        torch.as_tensor(t) for t in (data, null_mask, col_idx, col_mask,
                                     tr_idx, tr_mask, te_idx, te_mask))
    n_fam = mesh.shape.get("fam", 1)
    fams = _divides(col_idx.shape[0], n_fam, "families", "fam")
    shards = local_shards(mesh, "fam")
    if len(shards) < n_fam:
        raise ValueError("a fam shard has no device of this process; lay "
                         "'data' across processes (global_mesh)")
    outs = []
    for j, d in shards:
        fs = slice(j * fams, (j + 1) * fams)
        args = (data.to(d), null_mask.to(d), col_idx[fs].to(d, torch.long),
                col_mask[fs].to(d), tr_idx.to(d, torch.long), tr_mask.to(d),
                te_idx.to(d, torch.long), te_mask.to(d))
        score = (kde_ops.ckde_cv_alldevice_flash
                 if kde_ops.kernel_route(args[0])
                 else kde_ops.ckde_cv_alldevice)
        outs.append(score(*args, rule=rule))
    home = mesh.home
    return torch.cat([o.to(home) for o in outs])


def sharded_kde_slogl(mesh: Mesh, train_white, test_white, lognorm):
    """KDE sum-log-likelihood with the training points split over
    ``data``: each shard's per-test-row logsumexp over its rows
    (:func:`kde_logl_whitened` with lognorm 0: the KDE kernel on a float32
    CUDA shard, the dense form otherwise), gathered over ``data``
    (:func:`all_gather_data`), combined by a logsumexp over the shards,
    then ``+ lognorm`` and summed. One form on every device (the JAX
    package's pmax + psum form on CPU meshes was a speed choice). Training
    rows must divide ``data``."""
    train_white, test_white = (torch.as_tensor(t)
                               for t in (train_white, test_white))
    rows = _divides(train_white.shape[0], mesh.shape.get("data", 1),
                    "training rows", "data")
    parts = [kde_ops.kde_logl_whitened(
        train_white[i * rows: (i + 1) * rows].to(d), test_white.to(d), 0.0)
        for i, d in local_shards(mesh, "data")]
    lse = all_gather_data(mesh, parts)
    lognorm = torch.as_tensor(lognorm, dtype=lse.dtype, device=lse.device)
    return torch.sum(torch.logsumexp(lse, dim=0) + lognorm)
