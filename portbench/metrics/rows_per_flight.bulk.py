"""rows_per_flight: the request rows a server flight carried over the
window, ``real_rows / batches`` of the server's ``stats()`` counters
(deltas over the window; a chunk of a request larger than max_batch is
a flight of its own).  Padding to the bucket does not count."""


def read(run):
    flights = run.stats["batches"]
    return run.stats["real_rows"] / flights if flights else None
