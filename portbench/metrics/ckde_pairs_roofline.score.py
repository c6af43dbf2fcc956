"""Kernel #1 (``ckde_cv_pairs_f32``) against its roofline, in percent: the
least time the card could take for the work the calls need (the pairs of
valid train rows and test rows of the families, folds and node types the
benchmark made; an exp a pair and one more with evidence, over the SFU's
ex2 rate, or the FP32 operations or bytes where they take longer), over
#1's device time a call in the profiled sub-window."""

from portbench.harness import device, program


def read(run):
    prof, session = run.profile, run.session
    if prof is None or run.card is None or run.card["max_sm_hz"] is None:
        return None
    programs = [session.pairs_programs(i) for i in range(prof.calls)]
    kernel_s = prof.seconds(program.is_pairs_kernel)
    if any(p is None for p in programs) or kernel_s <= 0:
        return None
    bound = sum(device.bound_ms(run.card, *device.pairs_work(p))[0]
                for p in programs)
    return bound / (kernel_s * 1e3) * 100.0
