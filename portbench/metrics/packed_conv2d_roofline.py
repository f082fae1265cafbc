"""packed_conv2d_roofline: the least time the binary conv layers need
for the request rows launched in the traced slice (``counts.bound_s``:
operations at the assumed binary peak, or their 1-bit inputs, outputs
and weights at HBM bandwidth), over the device time the profiler saw
in ``packed_conv_kernel``, in percent.  Padded rows are work the
kernel did that no request needed, so padding lowers the share."""
from portbench import counts


def read(run):
    sl = run.slice
    if sl is None or sl.rows <= 0:
        return None
    spent = sl.kernel_time("packed_conv_kernel")
    if spent <= 0:
        return None
    return 100.0 * counts.bound_s(run.layers, sl.rows, integer=False) / spent
