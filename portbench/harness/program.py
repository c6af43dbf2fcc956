"""What the benchmark takes from the program under test
(``pybnesian_tpu_torch``) besides its entry points: the kernel wrappers'
launch counters, a ValidatedLikelihood that records the scores it returns
(and, when traced, the host time spent inside them), and the kernels'
names in a device trace."""

from __future__ import annotations

import time

import numpy as np

from .trace import span

# kernel wrappers of the port with a ``launches`` counter: (module, name)
COUNTERS = (
    ("ops.ckde_cv_kernel", "ckde_cv_pairs"),
    ("ops.kde_kernel", "kde_logl"),
    ("ops.cv_whiten_kernel", "ckde_cv_whiten"),
    ("ops.cv_whiten_kernel", "ckde_cv_fold_reduce"),
    ("ops.lg_cv_kernel", "lg_cv_stats"),
    ("ops.ucv_kernel", "ucv_pair_sums_cuda"),
    ("ops.ucv_search_kernel", "ucv_search_cuda"),
)


def launches():
    """{wrapper: launches so far} of every counted kernel wrapper."""
    import importlib

    out = {}
    for module, name in COUNTERS:
        mod = importlib.import_module("pybnesian_tpu_torch." + module)
        out[name] = getattr(mod, name).launches
    return out


def is_pairs_kernel(name):
    """Kernel #1, ``ckde_cv_pairs_f32``: ``pairs_kernel<D, R, true>``."""
    return "pairs_kernel<" in name and "true>" in name


def is_ucv_search_kernel(name):
    return "ucv_search_kernel" in name


def op_tuple(op):
    """An operator of the program as the reference's (kind, a, b)."""
    kind = type(op).__name__
    if kind == "ChangeNodeType":
        return ("type", op.node(), op.node_type().ToString())
    return ({"AddArc": "add", "RemoveArc": "remove", "FlipArc": "flip"}[kind],
            op.source(), op.target())


def spans():
    """Host seconds inside score calls, by channel (recorded only when
    traced)."""
    return {"cv": 0.0, "validation": 0.0}


def recording_validated_likelihood():
    """A ValidatedLikelihood that keeps what every score call returns in
    ``self.record``, as (channel, families, values, node types of the
    model then): :func:`scored` reads it back family by family. With
    ``self.spans`` set, it adds the host seconds of each call to its
    channel, in a ``pb.score.<channel>`` span."""
    from pybnesian_tpu_torch import ValidatedLikelihood

    class RecordingValidatedLikelihood(ValidatedLikelihood):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.record = []
            self.spans = None

        def _timed(self, channel, fn, *args):
            if self.spans is None:
                return fn(*args)
            t0 = time.perf_counter()
            try:
                with span("score." + channel):
                    return fn(*args)
            finally:
                self.spans[channel] += time.perf_counter() - t0

        def _keep(self, channel, model, families, values):
            types = {n: model.node_type(n) for n in model.nodes()}
            self.record.append((channel, list(families), values, types))

        def local_score_batch(self, model, families):
            out = self._timed("cv", super().local_score_batch, model,
                              families)
            self._keep("cv", model, families, out)
            return out

        def local_score_node_type(self, model, node_type, variable, parents):
            out = self._timed("cv", super().local_score_node_type, model,
                              node_type, variable, parents)
            self._keep("cv", model, [(variable, parents, node_type)], [out])
            return out

        def vlocal_score_batch(self, model, families):
            out = self._timed("validation", super().vlocal_score_batch,
                              model, families)
            self._keep("validation", model, families, out)
            return out

        def vlocal_score_node_type(self, model, node_type, variable,
                                   parents):
            out = self._timed("validation", super().vlocal_score_node_type,
                              model, node_type, variable, parents)
            self._keep("validation", model, [(variable, parents, node_type)],
                       [out])
            return out

    return RecordingValidatedLikelihood


def scored(record):
    """(channel, variable, parents, node type name, value) of every family
    a recording score returned."""
    for channel, families, values, types in record:
        for fam, v in zip(families, np.asarray(values, np.float64)):
            nt = fam[2] if len(fam) == 3 and fam[2] is not None \
                else types[fam[0]]
            yield channel, fam[0], tuple(fam[1]), nt.ToString(), float(v)
