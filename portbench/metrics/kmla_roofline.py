"""K6 (csrc/mla_decode.cu, absorbed-MLA decode): the least time its
launches in the traced round trip could take on the bytes and tensor-core
operations of their live rows' positions (costs/mla_moe.py) over the
device time of its kernel in the trace."""

KERNEL = "mla_decode_kernel"  # csrc/mla_decode.cu


def read(r):
    trace, need = r.get("trace"), r.get("k6_needed_s")
    if trace is None or not need:
        return None
    spent = trace.kernel_seconds(KERNEL)
    return 100.0 * need / spent if spent > 0 else None
