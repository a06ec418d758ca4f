"""K1 (csrc/decode_attention.cu, int8 cache): the least time its launches
in the traced round trip could take on the bytes their live rows need
(costs/kernels.py) over the device time of its kernel in the trace."""

KERNEL = "decode_kernel"


def read(r):
    trace, need = r.get("trace"), r.get("k1_needed_s")
    if trace is None or not need:
        return None
    spent = trace.kernel_seconds(KERNEL)
    return 100.0 * need / spent if spent > 0 else None
