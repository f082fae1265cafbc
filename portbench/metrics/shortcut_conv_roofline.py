"""shortcut_conv_roofline: the least time the projection shortcuts need
for the request rows launched in the traced slice
(``counts_bireal.projection_bound_s``: the 1x1 convs' operations at the
float32 peak, or their input and output maps at HBM bandwidth), over
the device time of the kernels whose name holds ``shortcut_conv``, in
percent.  Padded rows lower it."""
from portbench import counts_bireal


def read(run):
    sl = run.slice
    if sl is None or sl.rows <= 0:
        return None
    spent = sl.kernel_time("shortcut_conv")
    bound = counts_bireal.projection_bound_s(run.layers, sl.rows)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
