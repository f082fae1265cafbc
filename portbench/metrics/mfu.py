"""mfu: the whole forward's share of the card's peaks, in percent: the
least seconds an image needs at the peaks (``counts.least_s_per_image``:
the integer layers' operations at the int8 rate, the binary layers' at
the assumed binary rate), times the images answered in the window, over
the window's seconds."""
from portbench import counts


def read(run):
    if run.outcome.images <= 0:
        return None
    return 100.0 * counts.least_s_per_image(run.layers) * \
        run.outcome.images / run.seconds
