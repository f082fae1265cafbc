"""stem_conv_roofline: the least time the float stems need for the
request rows launched in the traced slice
(``counts_bireal.stem_bound_s``: the conv's operations at the float32
peak, or the pixels in and the pooled map and its signs out at HBM
bandwidth), over the device time of the kernels whose name holds
``stem_conv_``, in percent.  The stated precision (no FMA) caps it near
50%; padded rows lower it."""
from portbench import counts_bireal


def read(run):
    sl = run.slice
    if sl is None or sl.rows <= 0:
        return None
    spent = sl.kernel_time("stem_conv_")
    bound = counts_bireal.stem_bound_s(run.layers, sl.rows)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
