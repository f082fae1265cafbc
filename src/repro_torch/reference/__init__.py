"""Plain references the port is held against where the JAX package has
no counterpart: written in plain torch from the published equations,
importing nothing of the port (``reactnet``: ReActNet-A; ``bireal``:
Bi-Real Net-18)."""
