"""Roofline of the weight kernel (``csrc/mixture_logsumexp.cu``, called by
``ops/weights.py`` once per weighted set): a frozen copy of the bound's
arithmetic, counted from a call's shapes alone.

One call at n query rows x m centers x p parameters forms n * m logits,
each one ``ex2`` on the special-function units and the scheme's dot over
K = p + 2 (3K TF32 FMAs for "high", K BF16 FMAs for "default", K FP32 FMAs
for "highest"), and reads each input once and writes its output once
(float32). The least time is the largest of the three terms at one H100
SXM's published rates: 132 SMs at 1,980 MHz, 16 ex2, 1,024 TF32 FMAs,
2,048 BF16 FMAs and 128 FP32 FMAs per SM and clock, 3.35 TB/s."""

SMS = 132
SM_CLOCK_MHZ = 1980.0
SFU_PER_SM_CLOCK = 16
FMA_PER_SM_CLOCK = {"high": 1024, "default": 2048, "highest": 128}
FMA_PER_K = {"high": 3, "default": 1, "highest": 1}
HBM_BYTES_PER_S = 3.35e12
#: the kernel's launches as the trace names them (prologue and both
#: partial kernels, every scheme)
NAMES = ("mixture_partial_kernel", "ffma_partial_kernel", "prologue_kernel")


def terms_ms(n: int, m: int, p: int, scheme: str = "high") -> dict:
    per_ms = SMS * SM_CLOCK_MHZ * 1e3
    k = p + 2
    return {
        "ex2": n * m / (SFU_PER_SM_CLOCK * per_ms),
        "dot": FMA_PER_K[scheme] * k * n * m
        / (FMA_PER_SM_CLOCK[scheme] * per_ms),
        "bytes": 1e3 * 4 * (n * p + m * p + m + n) / HBM_BYTES_PER_S,
    }


def least_ms(n: int, m: int, p: int, scheme: str = "high") -> float:
    return max(terms_ms(n, m, p, scheme).values())


def calls(record) -> list:
    """(n, m, p, scheme) of every call in the traced fits: each set after a
    fit's first weighs its keep survivors against the previous set's."""
    tr = record["traffic"]
    out = []
    for fit in record["traced_fits"]:
        first, n_sets = fit["phases"]["first_set"], fit["phases"]["sets"]
        for t in range(max(first, 1), first + n_sets):
            out.append((tr.keeps[t], tr.keeps[t - 1], tr.npar,
                        record["weight_precision"]))
    return out
