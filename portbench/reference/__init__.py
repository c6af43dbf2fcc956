"""The plain reference that decides ``correct``.

Plain NumPy and PyTorch, written from the published definitions of the
scores and the search (PyBNesian's CV likelihood, hold-out likelihood,
normal-reference and UCV bandwidths, linear-Gaussian MLE, greedy
hill-climbing with a validation channel). It imports nothing of the
program under test and takes nothing it made: it works the folds, the
bandwidths, the fits, the scores and the search out again from the raw
columns the benchmark generated.

Every function takes the ``dtype`` it computes the pair sums in:
``torch.float64`` for the reference, ``torch.bfloat16`` for the control
(the reference one precision below the float32 the configurations state;
its small linear algebra then runs in float32, the lowest dtype
``torch.linalg`` takes).
"""
