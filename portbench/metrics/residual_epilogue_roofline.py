"""residual_epilogue_roofline: the least time the residual half-steps'
epilogues need for the request rows launched in the traced slice
(``counts_reactnet.epilogue_bound_s``: the int32 dot and the shortcut
in, the float32 stream and the next sign's bits out, at HBM
bandwidth), over the device time of the kernels whose name holds
``residual_epilogue``, in percent.  Padded rows are work the kernel
did that no request needed, so padding lowers the share."""
from portbench import counts_reactnet


def read(run):
    sl = run.slice
    if sl is None or sl.rows <= 0:
        return None
    spent = sl.kernel_time("residual_epilogue")
    if spent <= 0:
        return None
    return 100.0 * counts_reactnet.epilogue_bound_s(run.layers, sl.rows) \
        / spent
