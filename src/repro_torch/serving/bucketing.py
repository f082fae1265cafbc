"""Pow2 batch bucketing policy for the serving engine (DESIGN.md §9).

A copy of ``repro.serving.bucketing`` (the port imports nothing of the
reference).  Where the text below says "jit trace", the port's server
captures one CUDA graph (``repro_torch.graph.replay.GraphedApply``).

The server jits ``CompiledBNN.apply`` once per *bucket*, not once per
request batch size: a request batch of ``n`` rows is right-padded to
the smallest power of two >= ``n`` (clamped to ``max_batch``), so the
number of distinct jit traces is bounded by ``trace_bound(max_batch)``
— the prompt-length bucketing already proven out in launch/serve.py,
applied to the batch axis.  Pad rows are zeros (all-(-1) under the pm1
packing convention); every row's result is independent of the others,
so padding can only waste compute, never change bits, and the pad rows
are sliced off before results leave the server.

Request batches larger than ``max_batch`` are split into ``max_batch``
chunks plus a bucketed remainder (``split_rows``) — arbitrarily large
requests ride the same bounded trace set.

**Ragged last-bucket masking** (DESIGN.md §10): padding to the bucket
buys shape stability (one donation buffer + one sharding layout per
bucket) but, naively, also pays the bucket's full GEMM cost — 2x for a
33-row request on the 64 bucket.  The server therefore dispatches with
a *static row-validity count*: ``ragged_valid(n, bucket)`` rounds the
real row count up to eighth-bucket granularity (``mask_step``), and
``CompiledBNN.apply(..., valid_rows=)`` slices the batch to that count
before the first kernel, so the GEMMs only run the valid (rounded)
rows.  The rounding keeps the jit-trace count bounded: a bucket ``b``
only ever sees row counts in ``(b/2, b]``, which quantize to at most
four valid levels (``mask_levels``), so the per-kind trace bound is
``trace_bound(max_batch, ragged=True)`` — still O(log max_batch).
Worst-case masked over-compute is ``(b/2 + b/8) / (b/2 + 1)`` < 1.25x,
vs 2x unmasked.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "bucket_for",
    "bucket_sizes",
    "dispatch_grid",
    "mask_levels",
    "mask_step",
    "pow2_ceil",
    "ragged_valid",
    "split_rows",
    "trace_bound",
]


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"need a positive row count, got {n}")
    return 1 << (n - 1).bit_length()


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Every bucket the server can dispatch: 1, 2, 4, ... ``max_batch``
    (``max_batch`` itself must be a power of two)."""
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(f"max_batch must be a power of two, got {max_batch}")
    return tuple(1 << i for i in range(max_batch.bit_length()))


def bucket_for(n: int, max_batch: int) -> int:
    """The bucket an ``n``-row micro-batch dispatches under: the pow2
    ceiling of ``n``, clamped to ``max_batch``.  ``n`` must already be
    <= ``max_batch`` (``split_rows`` chunks oversized requests)."""
    if n > max_batch:
        msg = f"{n} rows exceed max_batch={max_batch}; split first (split_rows)"
        raise ValueError(msg)
    return min(pow2_ceil(n), max_batch)


def split_rows(n: int, max_batch: int) -> List[int]:
    """Chunk an ``n``-row request into dispatchable pieces: full
    ``max_batch`` chunks plus the remainder (which then buckets to its
    own pow2)."""
    if n < 1:
        raise ValueError(f"need a positive row count, got {n}")
    chunks = [max_batch] * (n // max_batch)
    if n % max_batch:
        chunks.append(n % max_batch)
    return chunks


def mask_step(bucket: int) -> int:
    """Granularity of the ragged row-validity mask for one bucket: the
    valid row count is rounded up to a multiple of ``bucket // 8`` (at
    least 1), so each bucket admits at most four distinct valid levels
    and the masked over-compute is bounded below 1.25x."""
    return max(1, bucket // 8)


def ragged_valid(n: int, bucket: int) -> int:
    """The static ``valid_rows`` an ``n``-row dispatch masks to on
    ``bucket``: ``n`` rounded up to the bucket's ``mask_step``, clamped
    to the bucket.  Rows beyond ``valid`` are pure shape padding and
    never reach a kernel; rows in ``[n, valid)`` are computed and
    discarded (the quantization cost of the bounded trace set)."""
    if not 1 <= n <= bucket:
        raise ValueError(f"need 1 <= rows <= bucket, got {n} on {bucket}")
    step = mask_step(bucket)
    return min(bucket, step * ((n + step - 1) // step))


def mask_levels(bucket: int) -> Tuple[int, ...]:
    """Every valid level bucket ``b`` can dispatch: the distinct
    ``ragged_valid`` values over the row counts that actually map to it
    (``(b/2, b]`` — smaller counts bucket lower)."""
    lo = bucket // 2 + 1
    return tuple(sorted({ragged_valid(n, bucket) for n in range(lo, bucket + 1)}))


def dispatch_grid(max_batch: int) -> Tuple[Tuple[int, int], ...]:
    """Every (bucket, valid_rows) pair the server can ever dispatch —
    the full jit-trace key set per input kind, and the prewarm set for
    ``CompiledBNN.tuning_keys_for_batches``."""
    return tuple((b, v) for b in bucket_sizes(max_batch) for v in mask_levels(b))


def trace_bound(max_batch: int, ragged: bool = False) -> int:
    """Hard upper bound on jit traces the bucketing policy admits per
    (input kind, mesh): one per bucket (log2(max_batch) + 1), or one
    per (bucket, valid-level) pair when ragged masking is on — at most
    four levels per bucket, so still O(log max_batch)."""
    if ragged:
        return len(dispatch_grid(max_batch))
    return len(bucket_sizes(max_batch))
