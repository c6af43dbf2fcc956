"""Kernel #1 (``ckde_cv_pairs_f32``) against its roofline in the learns of
the profiled sub-window, in percent: the least time the card could take
for the programs of every CKDE family those learns scored (a fold of the
CV channel each, and the hold-out's one, at the family's own width, not
the width its launch was padded to), over #1's device time in them. The
reader of ``ckde_pairs_roofline.score``, loaded: the loop gives the
programs (``pairs_programs``)."""

import os

from portbench.harness import spec

_SCORE = spec.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "ckde_pairs_roofline.score.py"),
    "portbench_metric_ckde_pairs_roofline_score")


def read(run):
    return _SCORE.read(run)
