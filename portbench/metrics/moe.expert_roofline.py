"""The held experts' grouped products (ops/moe.py, `torch._grouped_mm`):
the least time all of them in the traced round trip could take together,
on the bytes and bf16 tensor-core operations of the (token, held expert)
pairs the program's counters say were routed there (costs/mla_moe.py), over
the device time of the grouped GEMM kernels and the kernel that prepares
their problem list in the trace."""

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(r):
    trace, need = r.get("trace"), r.get("experts_needed_s")
    if trace is None or not need:
        return None
    spent = sum(trace.kernel_seconds(k) for k in KERNELS)
    return 100.0 * need / spent if spent > 0 else None
