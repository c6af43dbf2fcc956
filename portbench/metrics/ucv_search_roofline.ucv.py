"""The UCV search kernel (``ucv_search_f32``) against its roofline, in
percent: the least time the card could take for the pair sums the
searches needed (the counters ``ucv.lane_pairs.d<d>``: each problem's
evaluations times its valid pairs n(n-1)/2, by family width d; an exp a
pair over the SFU's ex2 rate, or its FP32 operations, 2d + 4 a pair up to
width 16 and 3d + 3 wider, where they take longer), over the kernel's
device time in the profiled sub-window. The rows, read once a search,
never bound it and are left out."""

from portbench.harness import device, phases, program

PREFIX = "ucv.lane_pairs.d"
# the widest family whose pair distance takes the dot form
DOT_D = 16


def work(pairs_by_width):
    """(exps, FP32 ops, bytes) of {family width: lane pairs}."""
    exps = float(sum(pairs_by_width.values()))
    ops = float(sum(p * (2 * d + 4 if d <= DOT_D else 3 * d + 3)
                    for d, p in pairs_by_width.items()))
    return exps, ops, 0.0


def read(run):
    prof, card = run.profile, run.card
    if prof is None or card is None or card["max_sm_hz"] is None:
        return None
    found = phases.counts(run) or {}
    pairs = {int(k[len(PREFIX):]): v for k, v in found.items()
             if k.startswith(PREFIX)}
    kernel_s = prof.seconds(program.is_ucv_search_kernel)
    if not pairs or kernel_s <= 0:
        return None
    bound = device.bound_ms(card, *work(pairs))[0]
    return bound / (kernel_s * 1e3) * 100.0
