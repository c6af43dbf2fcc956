"""The card a run uses, its published peaks, and the least time a kernel's
work could take on it (the bound a roofline share divides)."""

from __future__ import annotations

import subprocess

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
SFU_EX2_PER_CLOCK_PER_SM = 16
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def smi(query):
    """One ``nvidia-smi --query-gpu`` field of card 0, or None where the
    tool is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0].strip()


def card(torch):
    """{name, sms, max_sm_hz, power_limit_w} of card 0."""
    props = torch.cuda.get_device_properties(0)
    mhz = smi("clocks.max.sm")
    watts = smi("power.limit")
    return {
        "name": torch.cuda.get_device_name(0),
        "sms": props.multi_processor_count,
        "max_sm_hz": float(mhz) * 1e6 if mhz else None,
        "power_limit_w": float(watts) if watts else None,
    }


def bound_ms(card_info, exps, ops, nbytes):
    """(ms, what bounds it): the least time the card could take for
    ``exps`` SFU exps, ``ops`` FP32 operations (an FMA is 2) and ``nbytes``
    bytes, each input read once and each output written once."""
    times = {
        "sfu": exps / (card_info["sms"] * SFU_EX2_PER_CLOCK_PER_SM
                       * card_info["max_sm_hz"]),
        "fp32": ops / FP32_OPS_PER_S,
        "bytes": nbytes / HBM_BYTES_PER_S,
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def pairs_work(programs):
    """(exps, FP32 ops, bytes) that kernel #1 (``ckde_cv_pairs``) needs
    for ``programs``, a list of (valid train rows, test rows, columns,
    has evidence): every pair of a test row and a valid train row takes an
    exp for the joint and, with evidence, one for the marginal; its
    distance is 3 operations a column, the scale 1, each logsumexp step
    2, the marginal's correction 4. Bytes: each program's train rows
    (columns, the variable's coordinate and a row bias) and test rows
    (columns and the variable's coordinate) read once, one value a test
    row written."""
    exps = ops = nbytes = 0.0
    for ntr, nte, cols, evidence in programs:
        pairs = float(ntr) * nte
        marg = pairs if evidence else 0.0
        exps += pairs + marg
        ops += pairs * (3 * cols + 3) + marg * 6
        nbytes += 4 * (ntr * (cols + 2) + nte * (cols + 1) + nte + 2)
    return exps, ops, nbytes
