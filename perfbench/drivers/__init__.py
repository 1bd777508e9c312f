"""One module a traffic kind: ``build(ctx)`` returns the cell's steps
(``step``, ``step_spans``), its shape counts, and its ``check`` against
the plain reference; ``RATE``, ``TAIL`` and ``SPANS`` name its metrics
and spans."""
