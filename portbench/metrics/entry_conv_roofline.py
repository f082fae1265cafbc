"""entry_conv_roofline: the least time the integer (float-input) conv
layers need for the request rows launched in the traced slice
(``counts.bound_s``: operations at the int8 dense peak, or 8-bit inputs
and weights at HBM bandwidth), over the device time of the kernels the
profiler groups as "cuDNN float convs", in percent."""
from portbench import counts, profiling


def read(run):
    sl = run.slice
    if sl is None or sl.rows <= 0:
        return None
    spent = sl.group_s.get(profiling.CUDNN, 0.0)
    if spent <= 0:
        return None
    return 100.0 * counts.bound_s(run.layers, sl.rows, integer=True) / spent
