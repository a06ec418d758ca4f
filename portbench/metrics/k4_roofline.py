"""K4 (csrc/egnn_messages_bwd.cu): the least time its launches in the
traced training steps could take on the operations their live pairs need
(costs/kernels.py) over the device time of its kernel in the trace."""

KERNEL = "egnn_messages_bwd"


def read(r):
    trace, need = r.get("trace"), r.get("k4_needed_s")
    if trace is None or not need:
        return None
    spent = trace.kernel_seconds(KERNEL)
    return 100.0 * need / spent if spent > 0 else None
